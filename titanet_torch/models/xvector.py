"""x-vector (Snyder et al., ICASSP 2018), port of
``titanet_tpu/models/xvector.py``: the classic TDNN speaker embedding,
channels-last ``[B, T, C]``.

  frame1  TDNN(k=5, d=1) -> H        frame4  1x1 -> H
  frame2  TDNN(k=3, d=2) -> H        frame5  1x1 -> P (1500)
  frame3  TDNN(k=3, d=3) -> H
  stats pooling: [mean_t, std_t]  -> [B, 2P]
  segment6 affine -> E  (the x-vector, taken before any activation)

Each frame layer is ECAPA's :class:`~titanet_torch.models.ecapa.ConvReluBn`
(same-padded dilated conv -> ReLU -> BN, zeroed at padded frames), and the
statistics are masked, so a padded row's embedding equals the utterance's
solo embedding. H=512, P=1500 give ~4.4M parameters at E=512.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from titanet_torch.models import common
from titanet_torch.models.ecapa import ConvReluBn, _zero_padded
from titanet_torch.ops.dense import Dense


def stats_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """Mean + std over time in f32, mask-aware: ``[B, T, C] -> [B, 2C]`` in
    x's dtype."""
    xf = x.float()
    if mask is not None:
        m = mask.float()[..., None]
        n = torch.clamp(m.sum(dim=1), min=1.0)
        mean = (xf * m).sum(dim=1) / n
        var = ((xf - mean[:, None, :]) ** 2 * m).sum(dim=1) / n
    else:
        mean = xf.mean(dim=1)
        var = xf.var(dim=1, unbiased=False)
    std = torch.sqrt(torch.clamp(var, min=eps))
    return torch.cat([mean, std], dim=-1).to(x.dtype)


# (name, kernel size, dilation) of the frame layers; the last is P wide
FRAME_LAYERS = (("frame1", 5, 1), ("frame2", 3, 2), ("frame3", 3, 3), ("frame4", 1, 1), ("frame5", 1, 1))


class XVector(nn.Module):
    """mel ``[B, T, n_mels]`` -> raw x-vector ``[B, E]``."""

    def __init__(
        self,
        n_mels: int = 80,
        hidden_size: int = 512,
        frame_out: int = 1500,
        embedding_size: int = 192,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.embedding_size, self.dtype = embedding_size, dtype
        width = n_mels
        for name, k, dil in FRAME_LAYERS:
            feat = frame_out if name == "frame5" else hidden_size
            self.add_module(name, ConvReluBn(width, feat, k, dil, dtype=dtype))
            width = feat
        self.segment6 = Dense(2 * frame_out, embedding_size, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        common.reset_parameters(self, generator)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,  # calling convention; no dropout here
    ) -> torch.Tensor:
        h = _zero_padded(x, mask)
        for name, _, _ in FRAME_LAYERS:
            h = getattr(self, name)(h, mask=mask)
        return self.segment6(stats_pool(h, mask=mask))


def get_xvector(
    hidden_size: int = 512,
    frame_out: int = 1500,
    embedding_size: int = 192,
    n_mels: int = 80,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> XVector:
    """Preset constructor, in eval mode on ``device``, weights drawn from
    ``generator`` (default: seeded with 0)."""
    model = XVector(n_mels, hidden_size, frame_out, embedding_size, dtype=dtype)
    return common.finish(model, device, generator)
