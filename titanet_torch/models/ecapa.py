"""ECAPA-TDNN (Desplanques et al., Interspeech 2020, arXiv:2005.07143),
port of ``titanet_tpu/models/ecapa.py``, channels-last ``[B, T, C]``:

  layer1   Conv(n_mels -> C, k=5) -> ReLU -> BN
  layer2-4 SE-Res2Block(C, k=3, dilation 2/3/4, scale=8):
             1x1 Conv -> ReLU -> BN
             Res2Net dilated conv (hierarchical group convs) -> ReLU -> BN
             1x1 Conv -> ReLU -> BN
             SE, then + residual
  MFA      concat(layer2..4 outputs) [B, T, 3C] -> 1x1 Conv -> ReLU -> [B, T, 1536]
  pooling  channel- and context-dependent attentive stats
           (attention sees [x, mean_t(x), std_t(x)]) -> [B, 3072] -> BN
  head     Linear(3072 -> E) -> BN

Module attribute names are the JAX parameter tree's, so
:func:`titanet_torch.utils.weights.load_jax_variables` maps one onto the
other by path. ``mask`` (``[B, T]``) makes every statistic ignore padded
frames, and activations are zeroed at padded frames after each conv, so a
padded row's embedding equals the utterance's solo embedding. In training
(``model.train()``) the BatchNorm sites take ``mask`` where the JAX sites
do. There is no dropout. The pooling computes its context in f32 and then
the plain attentive statistics: no site of this family reaches the pool
kernel (nor, in the JAX package, its Pallas kernel).

Parameter counts: C=512 -> ~6.2M, C=1024 -> ~14.7M.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from titanet_torch.models import common
from titanet_torch.ops.conv import SamePadConv1d
from titanet_torch.ops.dense import Dense
from titanet_torch.ops.norm import BatchNorm
from titanet_torch.ops.pooling import attentive_stats
from titanet_torch.ops.se import SqueezeExcitation


def _zero_padded(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero activations at padded frames: conv bias and BN shift make them
    nonzero, and the next conv's receptive field would read them."""
    if mask is None:
        return x
    return x * mask[..., None].to(x.dtype)


class ConvReluBn(nn.Module):
    """Conv -> ReLU -> BN (ECAPA's block order; TitaNet's ConvBlock1d is
    conv -> BN -> ReLU)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 1,
        dilation: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.conv = SamePadConv1d(in_features, features, kernel_size, dilation=dilation, dtype=dtype)
        self.norm = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm(torch.relu(self.conv(x)), mask=mask)  # the mask reaches BN in training only
        return _zero_padded(x, mask)


class Res2DilatedConv(nn.Module):
    """Res2Net hierarchical dilated convolution (arXiv:1904.01169 §3): split
    C into ``scale`` groups of width C/scale; y_1 = x_1, y_2 = K_2(x_2),
    y_i = K_i(x_i + y_{i-1})."""

    def __init__(
        self,
        channels: int,
        kernel_size: int = 3,
        dilation: int = 1,
        scale: int = 8,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if channels % scale:
            raise ValueError("channels must divide res2net scale")
        self.scale, self.width = scale, channels // scale
        for i in range(1, scale):
            self.add_module(
                f"conv_{i}",
                SamePadConv1d(self.width, self.width, kernel_size, dilation=dilation, dtype=dtype),
            )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.width
        outs = [x[..., :w]]  # y_1 = x_1
        prev = None
        for i in range(1, self.scale):
            xi = x[..., i * w:(i + 1) * w]
            if prev is not None:
                xi = xi + prev
            # the hierarchical carry is zeroed at padded frames after every conv
            prev = _zero_padded(getattr(self, f"conv_{i}")(xi), mask)
            outs.append(prev)
        return torch.cat(outs, dim=-1)


class SERes2Block(nn.Module):
    """1x1 ConvReluBn -> Res2 dilated conv -> ReLU -> BN -> 1x1 ConvReluBn
    -> SE, plus the identity residual (arXiv:2005.07143 fig. 2)."""

    def __init__(
        self,
        features: int,
        kernel_size: int = 3,
        dilation: int = 1,
        scale: int = 8,
        se_bottleneck: int = 128,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.conv_in = ConvReluBn(features, features, 1, dtype=dtype)
        self.res2 = Res2DilatedConv(features, kernel_size, dilation, scale, dtype=dtype)
        self.res2_norm = BatchNorm(features, dtype=dtype)
        self.conv_out = ConvReluBn(features, features, 1, dtype=dtype)
        self.se = SqueezeExcitation(features, max(1, features // se_bottleneck), dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.conv_in(x, mask=mask)
        y = torch.relu(self.res2(y, mask=mask))
        y = _zero_padded(self.res2_norm(y, mask=mask), mask)
        y = self.conv_out(y, mask=mask)
        return x + self.se(y, mask=mask)


class ChannelContextAttentivePooling(nn.Module):
    """ECAPA's attentive statistics pooling (arXiv:2005.07143 §3.3): the
    scorer also sees the utterance's per-channel mean and std over time.

      context  = [x, mean_t(x), std_t(x)]          [B, T, 3C]
      energies = W2 tanh(W1 context + b1) + b2     [B, T, C]
      out      = attentive mean/std with per-channel alphas  [B, 2C]

    As in the JAX module the ``[B, T, 3C]`` context is never built:
    ``W1 context + b1 = x @ W1x + (mean @ W1m + std @ W1s + b1)``, the second
    term a ``[B, 1, H]`` bias. The mean and the variance (masked when
    ``mask`` is given) are computed in f32."""

    def __init__(
        self,
        channels: int,
        hidden_size: int = 128,
        eps: float = 1e-6,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.in_linear = Dense(3 * channels, hidden_size)
        self.out_linear = Dense(hidden_size, channels, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ch = x.shape[-1]
        xf = x.float()
        if mask is not None:
            m = mask.float()[..., None]
            n = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
            mean = (xf * m).sum(dim=1, keepdim=True) / n
            var = ((xf - mean) ** 2 * m).sum(dim=1, keepdim=True) / n
        else:
            mean = xf.mean(dim=1, keepdim=True)
            var = xf.var(dim=1, unbiased=False, keepdim=True)
        std = torch.sqrt(torch.clamp(var, min=self.eps))
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        w1 = self.in_linear.weight.to(dt)  # [H, 3C]
        # frame-independent context contribution: a [B, 1, H] bias
        ctx_bias = (
            F.linear(mean.to(dt), w1[:, ch:2 * ch])
            + F.linear(std.to(dt), w1[:, 2 * ch:])
            + self.in_linear.bias.to(dt)
        )
        e = torch.tanh(F.linear(x.to(dt), w1[:, :ch]) + ctx_bias)
        return attentive_stats(x, self.out_linear(e), mask=mask, eps=self.eps)


class EcapaTdnn(nn.Module):
    """Full ECAPA-TDNN: mel ``[B, T, n_mels]`` -> raw embedding ``[B, E]``,
    the calling convention of :class:`titanet_torch.models.TitaNet`."""

    def __init__(
        self,
        n_mels: int = 80,
        channels: int = 512,
        mfa_channels: int = 1536,
        embedding_size: int = 192,
        kernel_size: int = 3,
        dilations: tuple = (2, 3, 4),
        scale: int = 8,
        se_bottleneck: int = 128,
        attention_hidden_size: int = 128,
        prolog_kernel_size: int = 5,
        dtype: Optional[torch.dtype] = None,
        axis_name: Optional[str] = None,
    ):
        super().__init__()
        self.embedding_size, self.dtype, self.n_layers = embedding_size, dtype, len(dilations)
        self.layer1 = ConvReluBn(n_mels, channels, prolog_kernel_size, dtype=dtype)
        for i, dilation in enumerate(dilations):
            self.add_module(
                f"layer{i + 2}",
                SERes2Block(channels, kernel_size, dilation, scale, se_bottleneck, dtype=dtype),
            )
        self.mfa_conv = SamePadConv1d(len(dilations) * channels, mfa_channels, 1, dtype=dtype)
        self.pool = ChannelContextAttentivePooling(mfa_channels, attention_hidden_size, dtype=dtype)
        self.pool_norm = BatchNorm(2 * mfa_channels, dtype=dtype)
        self.linear = Dense(2 * mfa_channels, embedding_size, dtype=dtype)
        self.linear_norm = BatchNorm(embedding_size, dtype=dtype)
        common.set_axis_name(self, axis_name)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        common.reset_parameters(self, generator)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,  # calling convention; no dropout here
    ) -> torch.Tensor:
        h = self.layer1(_zero_padded(x, mask), mask=mask)
        outs = []
        for i in range(self.n_layers):
            h = getattr(self, f"layer{i + 2}")(h, mask=mask)
            outs.append(h)
        h = torch.relu(self.mfa_conv(torch.cat(outs, dim=-1)))  # MFA [B, T, 3C] -> [B, T, 1536]
        pooled = self.pool_norm(self.pool(h, mask=mask))
        return self.linear_norm(self.linear(pooled))


def get_ecapa(
    channels: int = 512,
    embedding_size: int = 192,
    n_mels: int = 80,
    attention_hidden_size: int = 128,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    axis_name: Optional[str] = None,
) -> EcapaTdnn:
    """Preset constructor (channels 512 ~6.2M params, 1024 ~14.7M), in eval
    mode on ``device``, weights drawn from ``generator`` (default: seeded
    with 0)."""
    model = EcapaTdnn(
        n_mels=n_mels,
        channels=channels,
        embedding_size=embedding_size,
        attention_hidden_size=attention_hidden_size,
        dtype=dtype,
        axis_name=axis_name,
    )
    return common.finish(model, device, generator)
