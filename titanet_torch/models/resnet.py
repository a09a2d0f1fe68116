"""ResNet speaker embedding (r-vector, arXiv:1910.12592), port of
``titanet_tpu/models/resnet.py``: 2-D residual convolutions over the mel
spectrogram as a 1-channel image.

  stem     Conv3x3(1 -> C) -> BN -> ReLU
  stage1   N1 x BasicBlock(C,    stride 1)
  stage2   N2 x BasicBlock(2C,   first block stride 2)     T,F halve
  stage3   N3 x BasicBlock(4C,   first block stride 2)     T,F halve
  stage4   N4 x BasicBlock(8C,   first block stride 2)     T,F halve
  pool     flatten freq x chan [B, T/8, F/8 * 8C] -> mean+std over time
  head     Linear -> E

The maps are ``[B, T, F, C]`` as in the JAX package (channels-last memory,
which the library's convolutions take as their ``[B, C, T, F]`` view), so
the flatten before pooling is frequency-major, channel-minor, as the JAX
``embedding`` kernel's rows are. The convs use fixed padding of k//2 a
side, not "SAME": output row j of a stride-2 conv is centred on input row
2j whatever the length's parity, so the time mask halves as
``mask[:, ::2]`` at each stride-2 block and a padded row's embedding equals
the utterance's solo embedding. In training the BatchNorm statistics take
the ``[B, T', F']`` mask. No dropout. depth=34 gives (3,4,6,3) blocks and
~6.3M parameters at C=32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from titanet_torch.models import common
from titanet_torch.models.xvector import stats_pool
from titanet_torch.ops.conv import Conv2d
from titanet_torch.ops.dense import Dense
from titanet_torch.ops.norm import BatchNorm


def _zero_padded_2d(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero invalid frames of a ``[B, T, F, C]`` map (mask ``[B, T]``)."""
    if mask is None:
        return x
    return x * mask[:, :, None, None].to(x.dtype)


def _bn_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Time mask ``[B, T]`` -> the ``[B, T, F]`` mask of BatchNorm's
    statistics over all non-channel positions."""
    if mask is None:
        return None
    return mask[:, :, None].expand(x.shape[:3])


class Conv2dBn(nn.Module):
    """Bias-free 3x3/1x1 conv with fixed padding, then BN."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel_size, stride, kernel_size // 2,
                           use_bias=False, dtype=dtype)
        self.norm = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.conv(x)
        return self.norm(x, mask=_bn_mask(x, mask) if self.training else None)


class BasicBlock2d(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv3x3 -> BN, + skip, ReLU (He et al.'s
    basic block; the skip is a 1x1 conv + BN where the shape changes)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        stride: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.conv1 = Conv2dBn(in_features, features, 3, stride, dtype=dtype)
        self.conv2 = Conv2dBn(features, features, 3, 1, dtype=dtype)
        self.down = (
            Conv2dBn(in_features, features, 1, stride, dtype=dtype)
            if stride != 1 or in_features != features else None
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask`` is the OUTPUT resolution's time mask."""
        h = _zero_padded_2d(torch.relu(self.conv1(x, mask=mask)), mask)
        h = self.conv2(h, mask=mask)
        skip = x if self.down is None else self.down(x, mask=mask)
        return _zero_padded_2d(torch.relu(h + skip), mask)


# depth -> per-stage block counts (He et al. Table 1, basic-block depths)
RESNET_DEPTHS: dict = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class SpeakerResNet(nn.Module):
    """mel ``[B, T, n_mels]`` -> raw embedding ``[B, E]``."""

    def __init__(
        self,
        depth: int = 34,
        base_channels: int = 32,
        embedding_size: int = 192,
        n_mels: int = 80,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if depth not in RESNET_DEPTHS:
            raise ValueError(f"depth must be one of {sorted(RESNET_DEPTHS)}, got {depth}")
        self.embedding_size, self.dtype = embedding_size, dtype
        self.stem = Conv2dBn(1, base_channels, 3, 1, dtype=dtype)
        self.blocks = []  # (name, stride) in order
        width, freq = base_channels, n_mels
        for stage, n_blocks in enumerate(RESNET_DEPTHS[depth]):
            feat = base_channels * 2**stage
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, BasicBlock2d(width, feat, stride, dtype=dtype))
                self.blocks.append((name, stride))
                width, freq = feat, -(-freq // stride)
        self.embedding = Dense(2 * freq * width, embedding_size, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        common.reset_parameters(self, generator)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,  # calling convention; no dropout here
    ) -> torch.Tensor:
        h = _zero_padded_2d(x[..., None], mask)  # [B, T, F, 1]: the mel map as a 1-channel image
        h = _zero_padded_2d(torch.relu(self.stem(h, mask=mask)), mask)
        for name, stride in self.blocks:
            if stride == 2 and mask is not None:
                mask = mask[:, ::2]  # output j is centred on input 2j
            h = getattr(self, name)(h, mask=mask)
        # [B, T', F', C] -> [B, T', F'*C], frequency-major: freq is fully
        # valid, so pooling stays time-only
        h = h.reshape(h.shape[0], h.shape[1], h.shape[2] * h.shape[3])
        return self.embedding(stats_pool(h, mask=mask))


def get_resnet(
    depth: int = 34,
    base_channels: int = 32,
    embedding_size: int = 192,
    n_mels: int = 80,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> SpeakerResNet:
    """Preset constructor (depth 34 / C=32 is the r-vector scale, ~6.3M
    params; depth 18 ~4.3M), in eval mode on ``device``, weights drawn from
    ``generator`` (default: seeded with 0)."""
    model = SpeakerResNet(depth, base_channels, embedding_size, n_mels, dtype=dtype)
    return common.finish(model, device, generator)
