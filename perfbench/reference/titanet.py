"""Plain TitaNet (Koluguri et al., arXiv:2110.04410) in float32, channels
last ``[B, T, C]``, as a function of a dict of named tensors.

  prolog: conv(n_mels -> H, k) -> BN -> relu
  N mega-blocks: 3 x [depthwise conv(k) -> pointwise conv -> BN -> relu ->
      dropout] -> squeeze-excitation (masked time mean -> fc -> relu -> fc
      -> sigmoid -> scale), plus a skip of pointwise conv -> BN; relu(skip +
      y) -> dropout
  epilog: pointwise conv(H -> 1536) -> BN -> relu
  decoder: attentive statistics pooling (energies W2 tanh(W1 x + b1) + b2,
      softmax over the valid frames, weighted mean and std) -> BN -> linear
      -> BN

BatchNorm normalizes with the batch mean and biased variance over the
(valid) frames in training, with the running statistics in evaluation;
eps 1e-5. Same-padded convolutions pad (k - 1) // 2 zeros each side.
Dropout keeps an element where a uniform draw is below ``1 - rate`` and
scales it by ``1 / (1 - rate)``. The names of the tensors are the ones the
measured program gives its parameters, so that the benchmark can hand both
sides one set of weights.

Plain torch only: nothing of the measured program is imported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """``(name, shape, init, fan_in)`` of every parameter in a fixed order;
    ``init`` is ``uniform`` (U(+-1/sqrt(fan_in))), ``ones`` or ``zeros``."""
    n_mels, h, k = cfg["frontend"]["n_mels"], cfg["hidden_size"], cfg["kernel_size"]
    o, a, e = cfg["output_size"], cfg["attention_hidden_size"], cfg["embedding_size"]
    r = h // cfg["se_reduction"]
    spec = []

    def conv(prefix, c_out, c_in_group, kernel):
        fan = c_in_group * kernel
        spec.append((f"{prefix}.weight", (c_out, c_in_group, kernel), "uniform", fan))
        spec.append((f"{prefix}.bias", (c_out,), "uniform", fan))

    def dense(prefix, c_out, c_in, bias=True):
        spec.append((f"{prefix}.weight", (c_out, c_in), "uniform", c_in))
        if bias:
            spec.append((f"{prefix}.bias", (c_out,), "uniform", c_in))

    def norm(prefix, c):
        spec.append((f"{prefix}.weight", (c,), "ones", 0))
        spec.append((f"{prefix}.bias", (c,), "zeros", 0))

    conv("encoder.prolog.conv", h, n_mels, cfg["prolog_kernel_size"])
    norm("encoder.prolog.norm", h)
    for i in range(cfg["n_mega_blocks"]):
        blk = f"encoder.mega_block_{i}"
        for j in range(cfg["n_sub_blocks"]):
            conv(f"{blk}.sub_block_{j}.conv.depthwise", h, 1, k)
            conv(f"{blk}.sub_block_{j}.conv.pointwise", h, h, 1)
            norm(f"{blk}.sub_block_{j}.norm", h)
        dense(f"{blk}.se.fc1", r, h, bias=False)
        dense(f"{blk}.se.fc2", h, r, bias=False)
        conv(f"{blk}.skip_conv", h, h, 1)
        norm(f"{blk}.skip_norm", h)
    conv("encoder.epilog.conv", o, h, cfg["epilog_kernel_size"])
    norm("encoder.epilog.norm", o)
    dense("decoder.pool.in_linear", a, o)
    dense("decoder.pool.out_linear", o, a)
    norm("decoder.pool_norm", 2 * o)
    dense("decoder.linear", e, 2 * o)
    norm("decoder.linear_norm", e)
    return spec


def norm_sites(cfg: dict) -> List[Tuple[str, int]]:
    """``(prefix, channels)`` of every BatchNorm, in forward order."""
    return [(name[:-len(".weight")], shape[0]) for name, shape, init, _ in param_spec(cfg)
            if init == "ones"]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int, rnd, dt) -> torch.Tensor:
    k = w.shape[-1]
    x, w, b = rnd(x.to(dt)), rnd(w.to(dt)), b.to(dt)
    if k == 1 and groups == 1:
        return F.linear(x, w[:, :, 0], b)
    # as a 2-D convolution over the [B, C, 1, T] view of the channels-last
    # activations, the form a measured program takes to avoid a transpose
    y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w.unsqueeze(2), b, padding=(0, (k - 1) // 2), groups=groups)
    return y.squeeze(2).transpose(1, 2)


class Net:
    """One forward pass over the weights ``p`` (and, in evaluation, the
    running statistics in ``p`` under ``<bn>.running_mean`` / ``_var``).

    ``train``: batch statistics; ``drop``: a callable ``shape -> bool keep
    mask`` (None: no dropout) and ``rate``; ``rnd``: the rounding of every
    product's operands and ``act`` of every activation a layer stores
    (:mod:`perfbench.reference.lowp`); ``calib``: a dict
    that receives each BatchNorm's batch mean and biased variance;
    ``remat``: recompute each mega-block in the backward (memory).

    ``dtype``: the compute dtype the configuration states. Below float32
    every product takes operands in it and gives a result in it, the
    activations stay in it, BatchNorm takes its batch statistics in
    float32, the time means take mask and count in it, and the softmax,
    mean and std of the pooling are float32; the parameters stay float32
    and their gradients come through the low-precision graph. Where the
    rest rounds is the configuration's ``precision`` group, which the
    reference reads and follows:

    - ``bn_apply``: BatchNorm folds its statistics with its scale and
      shift into a float32 affine and applies it in this dtype;
    - ``pool_epilog``: ``float32``, the epilog's BatchNorm and relu are
      applied in float32 on the way into the pooling, whose products take
      those activations rounded to the compute dtype and accumulate in
      float32 (:meth:`pool_fused`); the compute dtype, the epilog's
      output is rounded like every activation and the pooling's layers
      give results in the compute dtype (:meth:`pool`).

    In float32 the ``precision`` group is not read: every step is float32."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: dict, *, train: bool = False,
                 drop: Optional[Callable] = None, rate: float = 0.0, rnd=lambda x: x,
                 calib: Optional[dict] = None, remat: bool = False, dtype: torch.dtype = torch.float32,
                 act=lambda x: x):
        self.p, self.cfg, self.train = p, cfg, train
        self.drop, self.rate, self.rnd, self.act = drop, rate, rnd, act
        self.calib, self.remat, self.dt = calib, remat, dtype
        self.prec = {}
        if dtype != torch.float32:
            if "precision" not in cfg:
                raise ValueError("a configuration computed below float32 states its rounding points "
                                 "under 'precision' (bn_apply, pool_epilog)")
            self.prec = {k: getattr(torch, v) for k, v in cfg["precision"].items()
                         if k in ("bn_apply", "pool_epilog")}

    def stats(self, x, prefix, mask):
        """The (mean, biased variance) a BatchNorm normalizes with, float32."""
        p = self.p
        if not self.train:
            return p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        if mask is None:
            mean = xf.mean(dim=axes)
            var = xf.var(dim=axes, unbiased=False)
        else:
            m = mask[..., None]
            n = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(dim=axes) / n
            var = ((xf - mean) ** 2 * m).sum(dim=axes) / n
        if self.calib is not None:
            self.calib[prefix] = (mean.detach(), var.detach())
        return mean, var

    def fold(self, x, prefix, mask):
        """BatchNorm as a float32 affine ``(a, c)``: ``bn(x) = a x + c``."""
        mean, var = self.stats(x, prefix, mask)
        a = torch.rsqrt(var + BN_EPS) * self.p[f"{prefix}.weight"]
        return a, self.p[f"{prefix}.bias"] - mean * a

    def bn(self, x, prefix, mask):
        p = self.p
        if self.prec.get("bn_apply", torch.float32) != torch.float32:
            a, c = self.fold(x, prefix, mask)
            ap = self.prec["bn_apply"]
            return self.act((x.to(ap) * a.to(ap) + c.to(ap)).to(self.dt))
        mean, var = self.stats(x, prefix, mask)
        return self.act((x - mean) * torch.rsqrt(var + BN_EPS) * p[f"{prefix}.weight"] + p[f"{prefix}.bias"])

    def dropout(self, x, keep):
        if keep is None:
            return x
        return self.act(torch.where(keep, x * (1.0 / (1.0 - self.rate)),
                                    torch.zeros((), dtype=x.dtype, device=x.device)))

    def conv(self, x, prefix, groups=1):
        return self.act(_conv(x, self.p[f"{prefix}.weight"], self.p[f"{prefix}.bias"], groups, self.rnd, self.dt))

    def linear(self, x, prefix, bias=True):
        b = self.p[f"{prefix}.bias"].to(self.dt) if bias else None
        return self.act(F.linear(self.rnd(x.to(self.dt)), self.rnd(self.p[f"{prefix}.weight"].to(self.dt)), b))

    def block(self, x, i, mask, keeps):
        blk, h = f"encoder.mega_block_{i}", self.cfg["hidden_size"]
        y = x
        for j in range(self.cfg["n_sub_blocks"]):
            sub = f"{blk}.sub_block_{j}"
            y = self.conv(self.conv(y, f"{sub}.conv.depthwise", groups=h), f"{sub}.conv.pointwise")
            y = self.dropout(torch.relu(self.bn(y, f"{sub}.norm", mask)), keeps[j])
        if mask is None:
            squeezed = y.mean(dim=1)
        else:
            m = mask.to(y.dtype)[..., None]
            squeezed = (y * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        s = torch.relu(self.linear(squeezed, f"{blk}.se.fc1", bias=False))
        y = self.act(y * torch.sigmoid(self.linear(s, f"{blk}.se.fc2", bias=False))[:, None, :].to(y.dtype))
        skip = self.bn(self.conv(x, f"{blk}.skip_conv"), f"{blk}.skip_norm", mask)
        return self.dropout(self.act(torch.relu(skip + y)), keeps[-1])

    def pool(self, x, mask):
        e = self.linear(torch.tanh(self.linear(x, "decoder.pool.in_linear")), "decoder.pool.out_linear")
        if mask is not None:
            e = e.masked_fill(~mask[..., None].bool(), torch.finfo(e.dtype).min)
        alphas = torch.softmax(e.float(), dim=1)
        xf = x.float()
        mean = (alphas * xf).sum(dim=1)
        std = torch.sqrt(torch.clamp((alphas * xf * xf).sum(dim=1) - mean * mean, min=1e-6))
        return self.act(torch.cat([mean, std], dim=-1).to(x.dtype))

    def pool_fused(self, yf, mask=None):
        """The pooling with a float32 epilog: the products take the folded
        activations rounded to the compute dtype and accumulate in float32,
        the tanh's output is rounded again for the second product, the
        softmax (over the valid frames) and the moments are float32 over
        the unrounded activations."""
        p, rnd, dt = self.p, self.rnd, self.dt
        y = rnd(self.act(yf.to(dt))).float()
        u = torch.tanh(y @ rnd(p["decoder.pool.in_linear.weight"].to(dt)).float().t()
                       + p["decoder.pool.in_linear.bias"])
        e = (rnd(self.act(u.to(dt))).float() @ rnd(p["decoder.pool.out_linear.weight"].to(dt)).float().t()
             + p["decoder.pool.out_linear.bias"])
        if mask is not None:
            e = e.masked_fill(~mask[..., None].bool(), torch.finfo(e.dtype).min)
        alphas = torch.softmax(e, dim=1)
        mean = (alphas * yf).sum(dim=1)
        std = torch.sqrt(torch.clamp((alphas * yf * yf).sum(dim=1) - mean * mean, min=1e-6))
        return self.act(torch.cat([mean, std], dim=-1).to(dt))

    def __call__(self, mel: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mel [B, T, n_mels]`` -> raw embeddings ``[B, E]`` (not unit
        norm), in the compute dtype."""
        cfg = self.cfg
        x = torch.relu(self.bn(self.conv(mel, "encoder.prolog.conv"), "encoder.prolog.norm", mask))
        for i in range(cfg["n_mega_blocks"]):
            n_sites = cfg["n_sub_blocks"] + 1
            keeps = [None] * n_sites
            if self.drop is not None:
                keeps = [self.drop(x.shape) for _ in range(n_sites)]
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self.block, x, i, mask, keeps, use_reentrant=False)
            else:
                x = self.block(x, i, mask, keeps)
        x = self.conv(x, "encoder.epilog.conv")
        if self.prec.get("pool_epilog") == torch.float32:
            a, c = self.fold(x, "encoder.epilog.norm", mask)
            pooled = self.pool_fused(torch.relu(x.float() * a + c), mask)
        else:
            pooled = self.pool(torch.relu(self.bn(x, "encoder.epilog.norm", mask)), mask)
        pooled = self.bn(pooled, "decoder.pool_norm", None)
        return self.bn(self.linear(pooled, "decoder.linear"), "decoder.linear_norm", None)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
