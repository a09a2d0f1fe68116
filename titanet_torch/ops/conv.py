"""1D convolutions in channels-last ``[B, T, C]`` layout (port of
``titanet_tpu/ops/conv.py``).

- :class:`SamePadConv1d` — same-padding conv with the reference's padding
  formula. The pointwise case (K=1) is a matmul over ``[B*T, C]``.
- :class:`DepthwiseSeparableConv1d` — grouped K-tap conv + 1x1 pointwise.
- :class:`GroupedConv1d` — a grouped conv that never takes the kernel route
  below (a plain flax ``nn.Conv`` in the JAX package).
- :class:`Conv2d` — 2-D conv over ``[B, T, F, C]`` maps with fixed padding
  (the ResNet and the Conformer's subsampling).

A depthwise conv (groups == channels, stride 1) takes the one-pass
backward kernel (:mod:`titanet_torch.ops.kernels.dwconv`) when
``TITANET_DW_BWD=pallas`` and the kernel supports its shape (bf16, odd K,
C % 128 == 0, T <= 4096); the default, ``xla``, keeps the library conv's
own backward. The switch and its values are the JAX package's
(``titanet_tpu/ops/conv.py``).

Weights are stored in torch's ``Conv1d`` layout ``[out, in/groups, K]``.
A K>1 conv runs as a ``conv2d`` over the ``[B, C, 1, T]`` view of the
channels-last tensor, which is already in channels-last memory format, so
no transpose copy is made on the way in or out.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from titanet_torch.ops.kernels import dwconv


def dw_bwd_mode() -> str:
    """Depthwise-backward routing: ``xla`` (default: the library conv's
    backward) or ``pallas`` (the one-pass backward kernel)."""
    return os.environ.get("TITANET_DW_BWD", "xla")


def same_padding(length: int, kernel_size: int, stride: int, dilation: int) -> int:
    """Reference padding formula, applied to both sides."""
    return (
        stride * (length - 1) - length + kernel_size + (dilation - 1) * (kernel_size - 1)
    ) // 2


def torch_conv_init_(
    tensor: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """torch.nn.Conv1d/Linear default init in place: U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def conv1d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Same-padded conv: ``x [B, T, C_in]``, ``weight [C_out, C_in/groups, K]``
    -> ``[B, T_out, C_out]`` (``T_out == T`` for stride 1 and odd K)."""
    k = weight.shape[-1]
    pad = same_padding(x.shape[1], k, stride, dilation)
    x4 = x.transpose(1, 2).unsqueeze(2)  # [B, C, 1, T] in channels-last memory
    out = F.conv2d(
        x4, weight.unsqueeze(2), bias,
        stride=(1, stride), padding=(0, pad), dilation=(1, dilation), groups=groups,
    )
    return out.squeeze(2).transpose(1, 2).contiguous()


class SamePadConv1d(nn.Module):
    """Same-padding 1D convolution, channels-last. ``dtype`` is the compute
    dtype (inputs and weights are cast to it); parameters stay f32."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if in_features % groups:
            raise ValueError("channels must divide groups")
        self.kernel_size, self.stride, self.dilation, self.groups = (
            kernel_size, stride, dilation, groups,
        )
        self.dtype = dtype
        self.fan_in = (in_features // groups) * kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_conv_init_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            torch_conv_init_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        if self.kernel_size == 1 and self.stride == 1 and self.groups == 1:
            return F.linear(x, w[:, :, 0], b)
        ch = x.shape[-1]
        if (
            self.groups == ch == self.weight.shape[0]
            and self.stride == 1
            and self.dilation == 1
            and self.bias is not None
            and dw_bwd_mode() == "pallas"
            and dwconv.kernel_supports(x.shape[1], ch, self.kernel_size, x.dtype)
        ):
            return dwconv.depthwise_conv1d_fused_bwd(x, self.weight, self.bias)
        return conv1d_same(
            x, w, b, stride=self.stride, dilation=self.dilation, groups=self.groups
        )


class DepthwiseSeparableConv1d(nn.Module):
    """Depthwise (grouped, K-tap) conv followed by a pointwise 1x1 conv,
    both with a bias."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.depthwise = SamePadConv1d(
            in_features, in_features, kernel_size, stride=stride, dilation=dilation,
            groups=in_features, use_bias=use_bias, dtype=dtype,
        )
        self.pointwise = SamePadConv1d(
            in_features, features, 1, use_bias=use_bias, dtype=dtype
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class GroupedConv1d(SamePadConv1d):
    """A grouped same-padding conv that always runs the library conv: the
    counterpart of a plain flax ``nn.Conv(feature_group_count=...)`` (the
    MFA-Conformer's depthwise conv), which the JAX package never routes to
    its depthwise-backward kernel, whatever ``TITANET_DW_BWD`` says."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return conv1d_same(
            x, self.weight.to(x.dtype), b, stride=self.stride, dilation=self.dilation, groups=self.groups
        )


class Conv2d(nn.Module):
    """2-D convolution over channels-last maps ``[B, T, F, C]`` (the JAX
    package's flax ``nn.Conv`` layout) with torch-style fixed padding of
    ``padding`` on each side, so output row ``j`` of a stride-2 conv is
    centred on input row ``2j`` whatever the length's parity.

    Weights are stored in torch's ``Conv2d`` layout ``[out, in, kT, kF]``.
    The map is handed to the library as the ``[B, C, T, F]`` view of its
    channels-last memory and comes back the same way, so no transpose copy
    is made. ``dtype`` is the compute dtype (default: the promotion of the
    input's and f32); parameters stay f32."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.fan_in = in_features * kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_conv_init_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            torch_conv_init_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        w = self.weight.to(dt).contiguous(memory_format=torch.channels_last)
        b = self.bias.to(dt) if self.bias is not None else None
        out = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, b, stride=self.stride, padding=self.padding)
        return out.permute(0, 2, 3, 1).contiguous()
