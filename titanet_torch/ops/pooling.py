"""Attentive statistics pooling (port of ``titanet_tpu/ops/pooling.py``).

  energies = W2 tanh(W1 x + b1) + b2          # per-frame, per-channel
  alphas   = softmax(energies, axis=time)     # f32
  mean     = sum_t alphas * x
  std      = sqrt(clamp(sum_t alphas * x^2 - mean^2, eps))
  out      = concat([mean, std])              # [B, 2C]

With no mask, bf16 and aligned widths the whole chain runs in the fused
kernels (:func:`titanet_torch.ops.kernels.pool.attentive_pool_fused`, a
``torch.autograd.Function`` whose forward and backward are CUDA kernels),
including the optional ``relu(prescale * x + preshift)`` fold of an
upstream BatchNorm; under ``torch.export`` the forward is the registered
operator ``torch.ops.titanet_torch.attentive_pool_fwd`` instead. Otherwise
the plain path below runs; it is also the masked path. ``mask`` (``[B, T]``,
1 = valid) keeps padded frames out of the softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from titanet_torch.ops.dense import Dense
from titanet_torch.ops.kernels.pool import attentive_pool_fused, kernel_operands, kernel_supports


def attentive_stats(
    x: torch.Tensor,
    energies: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Softmax over time + weighted mean/std. x, energies: [B, T, C]."""
    if mask is not None:
        neg = torch.finfo(energies.dtype).min
        energies = energies.masked_fill(~mask[..., None].bool(), neg)
    alphas = torch.softmax(energies.float(), dim=1)
    xf = x.float()
    means = (alphas * xf).sum(dim=1)
    residuals = (alphas * xf**2).sum(dim=1) - means**2
    stds = torch.sqrt(torch.clamp(residuals, min=eps))
    return torch.cat([means, stds], dim=-1).to(x.dtype)


class AttentiveStatsPooling(nn.Module):
    def __init__(
        self,
        channels: int,
        hidden_size: int = 128,
        eps: float = 1e-6,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.hidden_size, self.eps, self.dtype = hidden_size, eps, dtype
        self.in_linear = Dense(channels, hidden_size)
        self.out_linear = Dense(hidden_size, channels)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        prescale: Optional[torch.Tensor] = None,
        preshift: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Pool ``x [B, T, C]``. With ``prescale``/``preshift`` (f32 fold
        vectors of an upstream BatchNorm), ``relu(prescale*x + preshift)``
        is applied first."""
        ch = x.shape[-1]
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        fold = prescale is not None
        use_kernel = (
            mask is None
            and x.dim() == 3
            and kernel_supports(ch, self.hidden_size, x.shape[1], dt)
        )
        wa, ba = self.in_linear.weight, self.in_linear.bias
        wb, bb = self.out_linear.weight, self.out_linear.bias
        if use_kernel:
            zeros = torch.zeros(ch, device=x.device, dtype=torch.float32)
            args = (x.to(dt), prescale if fold else zeros, preshift if fold else zeros,
                    wa.t(), ba, wb.t(), bb)
            if torch.compiler.is_exporting():
                # a traced graph holds the forward kernel as one operator node
                return torch.ops.titanet_torch.attentive_pool_fwd(
                    *kernel_operands(*args), self.eps, fold
                )
            return attentive_pool_fused(*args, self.eps, fold)
        if fold:
            x = torch.relu(x.float() * prescale + preshift).to(dt)
        e = torch.tanh(F.linear(x.to(dt), wa.to(dt), ba.to(dt)))
        e = F.linear(e, wb.to(dt), bb.to(dt))
        return attentive_stats(x, e, mask=mask, eps=self.eps)


class SimplePooling(nn.Module):
    """Average pool over time (the valid frames with ``mask``) + linear
    ``C -> 2C``: the ``simple_pool`` alternative to attentive pooling."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = Dense(channels, 2 * channels, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            m = mask.to(x.dtype)[..., None]
            pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        else:
            pooled = x.mean(dim=1)
        return self.linear(pooled)
