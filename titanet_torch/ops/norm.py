"""BatchNorm over the channel (last) axis, dropout (port of
``titanet_tpu/ops/norm.py``) and the LayerNorm of flax's ``nn.LayerNorm``.

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

Under an active mesh of P > 1 ranks (:mod:`titanet_torch.parallel.mesh`)
the training statistics are synchronized, by one of two rules:

- global batch (the JAX package's GSPMD step): each rank's ``(count, mean,
  M2)`` of its valid frames, packed in one tensor, are gathered from every
  rank in ONE differentiable collective and combined with Chan's parallel
  formula, so every rank normalizes with the masked mean and biased
  variance of the concatenated batch and publishes the global mean and the
  unbiased variance at the global count. The combination never forms
  ``E[x^2] - mean^2``, which loses f32 digits where the mean is far from 0;
- ``axis_name`` (the JAX ``shard_map`` step, ``titanet_tpu/ops/norm.py``):
  the equal-weight mean over ranks of the local means and of ``var +
  mean^2``, and ``count * P``, in one all-reduce.

The collective's backward carries every rank's gradient of the statistics
to the rows they came from. At P = 1 no collective is issued and the
local code runs unchanged.

Inside a rematerialized block (:class:`RematPass`) the backward runs the
block's forward a second time: there a BatchNorm neither publishes its
moments again nor issues its collective again (it takes the first pass's
result), and dropout takes the masks drawn before the block
(:meth:`FastDropout.keep_mask`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from titanet_torch.parallel import distributed as pd
from titanet_torch.parallel.mesh import active_mesh, draw_rows


class BatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        epsilon: float = 1e-5,
        dtype: Optional[torch.dtype] = None,
        axis_name: Optional[str] = None,
    ):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        # the mesh axis of the shard_map rule (None: the global-batch rule)
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # (batch mean, unbiased batch variance) of the last training forward
        self.batch_moments = None
        # the pass of a rematerialized block this module runs in, or None
        self.remat: Optional[RematPass] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _batch_stats(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """Batch mean and biased variance (f32) over all axes but the last
        (and, under an active mesh, over every rank's batch); publishes
        (mean, unbiased variance) in ``batch_moments``."""
        axes = tuple(range(x.dim() - 1))
        xf = x.float()
        if mask is not None and tuple(mask.shape) != tuple(x.shape[:-1]):
            raise ValueError(f"mask must be {tuple(x.shape[:-1])}, got {tuple(mask.shape)}")
        m = None if mask is None else mask.to(torch.float32)[..., None]
        mesh, global_batch = active_mesh()
        if mesh is not None and self.axis_name is not None:
            mean, var, count = self._pmean_stats(xf, m, axes, mesh)
        elif mesh is not None and global_batch:
            mean, var, count = self._global_stats(xf, m, axes, mesh)
        else:
            mean, var, count = _local_stats(xf, m, axes)
        if self.remat is None or not self.remat.replay:
            with torch.no_grad():
                denom = torch.clamp(torch.as_tensor(count, dtype=torch.float32) - 1.0, min=1.0)
                self.batch_moments = (mean.detach(), var.detach() * count / denom)
        return mean, var

    def _collective(self, fn):
        """``fn()``, this site's collective. In the recompute of a
        rematerialized block: the first pass's result, as a new leaf that
        requires grad as the result did (the recompute only refills the
        tensors the backward saved: the ops after the collective save the
        same ones)."""
        if self.remat is None:
            return fn()
        if self.remat.replay:
            out, grad = self.remat.results[id(self)]
            return out.detach().requires_grad_(grad)
        out = fn()
        self.remat.results[id(self)] = (out.detach(), out.requires_grad)
        return out

    def _pmean_stats(self, xf, m, axes, mesh):
        """The ``shard_map`` rule of the JAX module, ``axis_name`` set."""
        if self.axis_name != mesh.axis_name:
            raise ValueError(f"BatchNorm axis_name {self.axis_name!r} is not the active mesh's "
                             f"axis {mesh.axis_name!r}")
        mean, var, count = _local_stats(xf, m, axes)
        c = mean.shape[0]
        both = self._collective(
            lambda: pd.all_reduce(torch.cat([mean, var + mean * mean]), mesh.group, "batchnorm")) / mesh.size
        mean = both[:c]
        return mean, both[c:] - mean * mean, count * mesh.size

    def _global_stats(self, xf, m, axes, mesh):
        """The global-batch rule: Chan's combination of every rank's
        ``(count, mean, M2)``, gathered in one collective."""
        if m is not None:
            n = m.sum()
            mean = (xf * m).sum(dim=axes) / torch.clamp(n, min=1.0)
            m2 = ((xf - mean) ** 2 * m).sum(dim=axes)
        else:
            # made on the device: a host tensor's copy would be a pageable
            # host-to-device copy at every site, which a captured step refuses
            n = xf.new_full((), float(xf[..., 0].numel()))
            mean = xf.mean(dim=axes)
            m2 = ((xf - mean) ** 2).sum(dim=axes)
        c = mean.shape[0]
        packed = torch.cat([n.reshape(1), mean, m2])[None]
        g = self._collective(  # [P, 1 + 2C]
            lambda: pd.all_gather_rows(packed, mesh.rank, mesh.size, mesh.group, "batchnorm"))
        ns, means, m2s = g[:, :1], g[:, 1:1 + c], g[:, 1 + c:]
        count = torch.clamp(ns.sum(), min=1.0)
        mean = (ns * means).sum(dim=0) / count
        m2 = m2s.sum(dim=0) + (ns * (means - mean) ** 2).sum(dim=0)
        return mean, m2 / count, count.detach()

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


class RematPass:
    """The passes of one rematerialized block (``torch.utils.checkpoint``):
    the forward, then the recompute that the backward runs (``replay``).
    Each BatchNorm of the block holds it in ``remat`` while a pass runs;
    ``results`` keeps each site's collective result from the forward."""

    def __init__(self):
        self.replay = False
        self.results: dict = {}


def _local_stats(xf: torch.Tensor, m: Optional[torch.Tensor], axes):
    """``(mean, biased variance, count)`` of this rank's rows (masked: of
    the valid frames, count at least 1)."""
    if m is not None:
        count = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(dim=axes) / count
        var = ((xf - mean) ** 2 * m).sum(dim=axes) / count
    else:
        count = float(xf[..., 0].numel())
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, unbiased=False)
    return mean, var, count


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
    Only the distribution matches the JAX package, not the draws. Under an
    active mesh the draws are made over the global batch
    (:func:`titanet_torch.parallel.mesh.draw_rows`).
    Identity in eval mode and at rate 0; zeros at rate >= 1.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def keep_mask(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        """The draw of :meth:`forward` on an input of ``x``'s shape: the
        bool mask of kept elements, or None where the forward draws
        nothing (eval mode, rate 0, rate >= 1)."""
        if not self.training or self.rate == 0.0 or self.rate >= 1.0:
            return None
        keep_p = 1.0 - self.rate
        if keep_p * 256 == int(keep_p * 256):
            bits = draw_rows(lambda s: torch.randint(
                0, 256, s, generator=generator, device=x.device, dtype=torch.uint8
            ), x.shape)
            return bits < int(keep_p * 256)
        return draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device), x.shape) < keep_p

    def forward(
        self,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        keep: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``keep``: a mask :meth:`keep_mask` drew ahead (a rematerialized
        block draws its sites' masks before the checkpointed call); None
        draws it here."""
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if keep is None:
            keep = self.keep_mask(x, generator)
        keep_p = 1.0 - self.rate
        return torch.where(keep, x * (1.0 / keep_p), torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (torch's
    default is 1e-5), statistics and the affine map in f32 whatever the
    input's dtype, the result in ``dtype`` (default: the promotion of the
    input's and f32). ``weight``/``bias`` are flax's ``scale``/``bias``."""

    def __init__(self, num_features: int, epsilon: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(), self.epsilon)
        return y.to(dt)
