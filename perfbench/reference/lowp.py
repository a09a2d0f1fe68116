"""The control's lower precision: float8 e4m3 with a per-tensor scale (the
largest magnitude maps to 448), at every point where the configuration's
bfloat16 rounds: the operands of each product and each activation a layer
stores, as a float8 path in the program's place would compute. The
rounding is a straight-through function: the backward passes the gradient
through unchanged, so the gradients are taken of the rounded forward."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, in ``x``'s dtype."""
    return _RoundFp8.apply(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDINGS = {"f32": identity, "fp8": fp8}
