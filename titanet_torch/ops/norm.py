"""BatchNorm over the channel (last) axis and dropout (port of
``titanet_tpu/ops/norm.py``).

BatchNorm keeps torch's semantics, as the JAX module reproduces them:

- training normalizes with the batch mean and the *biased* batch variance,
  both computed from an f32 upcast; ``mask=`` (``[B, T]``, 1 = valid frame)
  restricts them to valid frames;
- the running-variance update uses the *unbiased* variance, momentum 0.1
  (``new = (1-m)*old + m*batch``);
- f32: ``(x - mean) * rsqrt(var + eps) * scale + bias``, in f32;
- low-precision input (the compute dtype is not f32 and ``x`` is already in
  it): fold into per-channel ``a, b`` in f32 once, then ONE multiply-add in
  the compute dtype;
- ``return_scale_shift=True``: return the f32 fold vectors ``(a, c)`` with
  ``bn(x) == x * a + c`` for a consumer that applies them itself (the
  fused pooling kernel). In training they come from the batch statistics,
  so gradients reach the mean and variance through ``a`` and ``c``.

The running-statistics update is deferred, as in the JAX train step: a
module in training mode publishes its batch moments in ``batch_moments``,
and :func:`ema_update_batch_stats` folds every site's moments into its
running statistics in one update after the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        epsilon: float = 1e-5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # (batch mean, unbiased batch variance) of the last training forward
        self.batch_moments = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _batch_stats(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """Batch mean and biased variance (f32) over all axes but the last;
        publishes (mean, unbiased variance) in ``batch_moments``."""
        axes = tuple(range(x.dim() - 1))
        xf = x.float()
        if mask is not None:
            if tuple(mask.shape) != tuple(x.shape[:-1]):
                raise ValueError(
                    f"mask must be {tuple(x.shape[:-1])}, got {tuple(mask.shape)}"
                )
            m = mask.to(torch.float32)[..., None]
            count = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(dim=axes) / count
            var = ((xf - mean) ** 2 * m).sum(dim=axes) / count
        else:
            count = float(x[..., 0].numel())
            mean = xf.mean(dim=axes)
            var = xf.var(dim=axes, unbiased=False)
        with torch.no_grad():
            denom = torch.clamp(torch.as_tensor(count, dtype=torch.float32) - 1.0, min=1.0)
            self.batch_moments = (mean.detach(), var.detach() * count / denom)
        return mean, var

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        return_scale_shift: bool = False,
    ):
        """Normalize ``x``; ``mask`` is used only in training."""
        if self.training:
            mean, var = self._batch_stats(x, mask)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.epsilon)
        scale, bias = self.weight.float(), self.bias.float()
        if return_scale_shift:
            a = inv * scale
            return a, bias - mean * a
        dtype = self.dtype or x.dtype
        if dtype != torch.float32 and x.dtype == dtype:
            a = inv * scale
            b = bias - mean * a
            return x * a.to(dtype) + b.to(dtype)
        return ((x.float() - mean) * inv * scale + bias).to(dtype)


@torch.no_grad()
def ema_update_batch_stats(module: nn.Module, momentum: float = 0.1) -> int:
    """One update of every BatchNorm site's running statistics from the
    batch moments its last training forward published:
    ``new = (1-m)*old + m*batch`` over all sites at once (two ``_foreach``
    ops). Clears the published moments; returns the number of sites."""
    sites = [m for m in module.modules() if isinstance(m, BatchNorm) and m.batch_moments is not None]
    if not sites:
        return 0
    olds, news = [], []
    for m in sites:
        olds += [m.running_mean, m.running_var]
        news += [t.to(m.running_mean.dtype) for t in m.batch_moments]
        m.batch_moments = None
    torch._foreach_mul_(olds, 1.0 - momentum)
    torch._foreach_add_(olds, news, alpha=momentum)
    return len(sites)


class FastDropout(nn.Module):
    """Dropout that keeps each element with probability ``1 - rate`` and
    scales kept values by ``1/(1-rate)`` (in the input's dtype).

    The draws come from the ``generator`` passed to :meth:`forward` (torch's
    default generator when None). As in the JAX module, a keep probability
    that 8 bits represent exactly (0.5 for TitaNet) compares one random byte
    per element with ``keep * 256``; other rates compare a uniform f32.
    Only the distribution matches the JAX package, not the draws.
    Identity in eval mode and at rate 0; zeros at rate >= 1.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep_p = 1.0 - self.rate
        if keep_p * 256 == int(keep_p * 256):
            bits = torch.randint(
                0, 256, x.shape, generator=generator, device=x.device, dtype=torch.uint8
            )
            keep = bits < int(keep_p * 256)
        else:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_p
        return torch.where(keep, x * (1.0 / keep_p), torch.zeros((), dtype=x.dtype, device=x.device))
