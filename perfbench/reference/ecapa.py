"""Plain ECAPA-TDNN (Desplanques, Thienpondt and Demuynck, Interspeech 2020,
arXiv:2005.07143) in float32, channels last ``[B, T, C]``, as a function of
a dict of named tensors.

  layer1   conv(n_mels -> C, k) -> relu -> BN
  layer2-4 SE-Res2Block(C, k=3, dilation 2 / 3 / 4, scale 8): 1x1 conv ->
           relu -> BN; Res2 dilated conv (y_1 = x_1, y_i = K_i(x_i + y_{i-1}))
           -> relu -> BN; 1x1 conv -> relu -> BN; squeeze-excitation (masked
           time mean -> fc -> relu -> fc -> sigmoid -> scale); plus the
           block's input
  MFA      concat(layer2..4) [B, T, 3C] -> 1x1 conv -> relu
  pooling  e = W2 tanh(W1 [h, mean, std] + b1) + b2 with the mean and std
           over the valid frames, a softmax over them a channel, the
           weighted mean and std -> BN
  head     linear -> BN

Departures from the paper, as the measured program reads it (and the
configuration's ``assumed`` lists): 80 log-mel bands for the paper's 80
MFCCs; the Res2 groups' convolutions without a ReLU and BN of their own, one
ReLU and BN after their concat; the squeeze-excitation's linear layers
without biases; the attention's hidden layer without a BatchNorm; MFA 1536.
A copy of ``tests/torch_ecapa_reference.py`` with what the benchmark needs:
the parameters' names, shapes and initialisation (:func:`param_spec`), the
batch statistics of training mode for calibration, the configuration's
rounding points, the control's rounding, the planted faults and the
embedding of whole utterances by the serving rules of
:mod:`perfbench.reference.embed`.

BatchNorm normalizes with the batch mean and biased variance over the
valid frames in training, with the running statistics in evaluation; eps
1e-5. Activations are zeroed at padded frames after each convolution.

Plain torch only: nothing of the measured program is imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.embed import bucket_for, window_lengths
from perfbench.reference.frontend import log_mel
from perfbench.reference.titanet import unit

BN_EPS = 1e-5
POOL_EPS = 1e-6
FAULTS = ("no_context", "padded_context")


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """``(name, shape, init, fan_in)`` of every parameter in a fixed order,
    under the measured program's names; ``init`` is ``uniform``
    (U(+-1/sqrt(fan_in))), ``ones`` or ``zeros``."""
    n_mels, c, k = cfg["frontend"]["n_mels"], cfg["channels"], cfg["kernel_size"]
    w, mfa, a, e = c // cfg["scale"], cfg["mfa_channels"], cfg["attention_hidden_size"], cfg["embedding_size"]
    se = c // max(1, c // cfg["se_bottleneck"])  # the program's squeeze width: C / (C // bottleneck)
    spec = []

    def conv(prefix, c_out, c_in, kernel):
        spec.append((f"{prefix}.weight", (c_out, c_in, kernel), "uniform", c_in * kernel))
        spec.append((f"{prefix}.bias", (c_out,), "uniform", c_in * kernel))

    def dense(prefix, c_out, c_in, bias=True):
        spec.append((f"{prefix}.weight", (c_out, c_in), "uniform", c_in))
        if bias:
            spec.append((f"{prefix}.bias", (c_out,), "uniform", c_in))

    def norm(prefix, ch):
        spec.append((f"{prefix}.weight", (ch,), "ones", 0))
        spec.append((f"{prefix}.bias", (ch,), "zeros", 0))

    conv("layer1.conv", c, n_mels, cfg["prolog_kernel_size"])
    norm("layer1.norm", c)
    for i in range(len(cfg["dilations"])):
        blk = f"layer{i + 2}"
        conv(f"{blk}.conv_in.conv", c, c, 1)
        norm(f"{blk}.conv_in.norm", c)
        for j in range(1, cfg["scale"]):
            conv(f"{blk}.res2.conv_{j}", w, w, k)
        norm(f"{blk}.res2_norm", c)
        conv(f"{blk}.conv_out.conv", c, c, 1)
        norm(f"{blk}.conv_out.norm", c)
        dense(f"{blk}.se.fc1", se, c, bias=False)
        dense(f"{blk}.se.fc2", c, se, bias=False)
    conv("mfa_conv", mfa, len(cfg["dilations"]) * c, 1)
    dense("pool.in_linear", a, 3 * mfa)
    dense("pool.out_linear", mfa, a)
    norm("pool_norm", 2 * mfa)
    dense("linear", e, 2 * mfa)
    norm("linear_norm", e)
    return spec


def norm_sites(cfg: dict) -> List[Tuple[str, int]]:
    """``(prefix, channels)`` of every BatchNorm, in forward order."""
    return [(name[:-len(".weight")], shape[0]) for name, shape, init, _ in param_spec(cfg) if init == "ones"]


class Net:
    """One forward pass over the weights ``p`` (and, in evaluation, the
    running statistics in ``p`` under ``<bn>.running_mean`` / ``_var``).

    ``train``: batch statistics; ``calib``: a dict that receives each
    BatchNorm's batch mean and biased variance; ``rnd``: the rounding of
    every product's operands and ``act`` of every activation a layer
    stores (:mod:`perfbench.reference.lowp`); ``fault``: one of
    :data:`FAULTS` planted in the pooling (``no_context``: the context term
    left out of the attention; ``padded_context``: the context statistics
    taken over the padded frames too).

    ``dtype``: the compute dtype the configuration states. Below float32
    every product takes operands in it and gives a result in it, the
    activations stay in it, BatchNorm takes its batch statistics in
    float32, the time means take mask and count in it, and the pooling's
    arithmetic is float32; the parameters stay float32. Where the rest
    rounds is the configuration's ``precision`` group, which the reference
    reads and follows:

    - ``bn_apply``: BatchNorm folds its statistics with its scale and shift
      into a float32 affine and applies it in this dtype;
    - ``pool``: ``float32``: the context's mean and std over the valid
      frames, the context's product (its operands, mean | std and W1's
      context columns, rounded to the compute dtype), the first product (h
      and W1's frame columns rounded), the tanh, the second product (u and
      W2 rounded), the energies, the softmax and the moments accumulate and
      stay in float32 over the rounded activations; the pooled output is
      rounded to the compute dtype.

    In float32 the ``precision`` group is not read: every step is float32."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: dict, *, train: bool = False, rnd=lambda x: x,
                 act=lambda x: x, calib: Optional[dict] = None, dtype: torch.dtype = torch.float32,
                 fault: Optional[str] = None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.p, self.cfg, self.train, self.rnd, self.act = p, cfg, train, rnd, act
        self.calib, self.dt, self.fault = calib, dtype, fault
        self.prec = {}
        if dtype != torch.float32:
            if "precision" not in cfg:
                raise ValueError("a configuration computed below float32 states its rounding points "
                                 "under 'precision' (bn_apply, pool)")
            self.prec = {k: getattr(torch, v) for k, v in cfg["precision"].items() if k in ("bn_apply", "pool")}
            if self.prec.get("pool") != torch.float32:
                raise ValueError("the reference follows a float32 pooling ('pool': 'float32') only")

    def stats(self, x, prefix, mask):
        """The (mean, biased variance) a BatchNorm normalizes with, float32."""
        p = self.p
        if not self.train:
            return p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        if mask is None:
            mean, var = xf.mean(dim=axes), xf.var(dim=axes, unbiased=False)
        else:
            m = mask[..., None]
            n = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(dim=axes) / n
            var = ((xf - mean) ** 2 * m).sum(dim=axes) / n
        if self.calib is not None:
            self.calib[prefix] = (mean.detach(), var.detach())
        return mean, var

    def bn(self, x, prefix, mask=None):
        p = self.p
        mean, var = self.stats(x, prefix, mask)
        if self.prec.get("bn_apply", torch.float32) != torch.float32:
            a = torch.rsqrt(var + BN_EPS) * p[f"{prefix}.weight"]
            c = p[f"{prefix}.bias"] - mean * a
            ap = self.prec["bn_apply"]
            return self.act((x.to(ap) * a.to(ap) + c.to(ap)).to(self.dt))
        return self.act((x - mean) * torch.rsqrt(var + BN_EPS) * p[f"{prefix}.weight"] + p[f"{prefix}.bias"])

    def zero(self, x, mask):
        return x if mask is None else x * mask.to(x.dtype)[..., None]

    def conv(self, x, prefix, dilation=1):
        w, b = self.p[f"{prefix}.weight"], self.p[f"{prefix}.bias"]
        x, w, b = self.rnd(x.to(self.dt)), self.rnd(w.to(self.dt)), b.to(self.dt)
        k = w.shape[-1]
        if k == 1:
            return self.act(F.linear(x, w[:, :, 0], b))
        # as a 2-D convolution over the [B, C, 1, T] view of the channels-last
        # activations, the form a measured program takes to avoid a transpose
        y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w.unsqueeze(2), b, padding=(0, dilation * (k - 1) // 2),
                     dilation=(1, dilation))
        return self.act(y.squeeze(2).transpose(1, 2))

    def linear(self, x, prefix, bias=True):
        b = self.p[f"{prefix}.bias"].to(self.dt) if bias else None
        return self.act(F.linear(self.rnd(x.to(self.dt)), self.rnd(self.p[f"{prefix}.weight"].to(self.dt)), b))

    def conv_relu_bn(self, x, prefix, mask, dilation=1):
        return self.zero(self.bn(torch.relu(self.conv(x, f"{prefix}.conv", dilation)), f"{prefix}.norm", mask), mask)

    def time_mean(self, y, mask):
        if mask is None:
            return y.mean(dim=1)
        m = mask.to(y.dtype)[..., None]
        return (y * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)

    def block(self, x, prefix, mask, dilation):
        scale = self.cfg["scale"]
        y = self.conv_relu_bn(x, f"{prefix}.conv_in", mask)
        width = y.shape[-1] // scale
        outs, prev = [y[..., :width]], None
        for i in range(1, scale):
            xi = y[..., i * width:(i + 1) * width]
            if prev is not None:
                xi = self.act(xi + prev)
            prev = self.zero(self.conv(xi, f"{prefix}.res2.conv_{i}", dilation), mask)
            outs.append(prev)
        y = self.zero(self.bn(torch.relu(torch.cat(outs, dim=-1)), f"{prefix}.res2_norm", mask), mask)
        y = self.conv_relu_bn(y, f"{prefix}.conv_out", mask)
        s = torch.relu(self.linear(self.time_mean(y, mask), f"{prefix}.se.fc1", bias=False))
        gate = torch.sigmoid(self.linear(s, f"{prefix}.se.fc2", bias=False))
        y = self.act(y * gate[:, None, :].to(y.dtype))
        return self.act(x + y)

    def pool(self, h, mask):
        """The context-dependent attentive statistics, float32 over the
        stored (rounded) activations; ``[B, 2C]`` in the compute dtype."""
        p, rnd, dt = self.p, self.rnd, self.dt
        c = h.shape[-1]
        hf = h.float()
        cmask = None if self.fault == "padded_context" else mask
        if cmask is None:
            mean = hf.mean(dim=1)
            var = hf.var(dim=1, unbiased=False)
        else:
            m = cmask.float()[..., None]
            n = torch.clamp(m.sum(dim=1), min=1.0)
            mean = (hf * m).sum(dim=1) / n
            var = ((hf - mean[:, None]) ** 2 * m).sum(dim=1) / n
        std = torch.sqrt(torch.clamp(var, min=POOL_EPS))
        w1, b1 = p["pool.in_linear.weight"], p["pool.in_linear.bias"]
        ctx = torch.cat([mean, std], dim=-1)
        if self.fault == "no_context":
            bias = b1.expand(h.shape[0], -1)
        else:
            bias = rnd(ctx.to(dt)).float() @ rnd(w1[:, c:].to(dt)).float().t() + b1
        u = torch.tanh(rnd(h.to(dt)).float() @ rnd(w1[:, :c].to(dt)).float().t() + bias[:, None, :])
        e = (rnd(self.act(u.to(dt))).float() @ rnd(p["pool.out_linear.weight"].to(dt)).float().t()
             + p["pool.out_linear.bias"])
        if mask is not None:
            e = e.masked_fill(mask[..., None] == 0, float("-inf"))
        alpha = torch.softmax(e, dim=1)
        am = (alpha * hf).sum(dim=1)
        astd = torch.sqrt(torch.clamp((alpha * hf * hf).sum(dim=1) - am * am, min=POOL_EPS))
        return self.act(torch.cat([am, astd], dim=-1).to(dt))

    def __call__(self, mel: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mel [B, T, n_mels]`` -> raw embeddings ``[B, E]`` (not unit
        norm), in the compute dtype."""
        h = self.conv_relu_bn(self.zero(mel, mask), "layer1", mask)
        outs = []
        for i, d in enumerate(self.cfg["dilations"]):
            h = self.block(h, f"layer{i + 2}", mask, d)
            outs.append(h)
        h = torch.relu(self.conv(torch.cat(outs, dim=-1), "mfa_conv"))
        pooled = self.bn(self.pool(h, mask), "pool_norm")
        return self.bn(self.linear(pooled, "linear"), "linear_norm")


@torch.no_grad()
def embed_utterances(weights: Dict[str, torch.Tensor], cfg: dict, waves: Sequence[np.ndarray],
                     buckets: Sequence[int], overlap: float, device, batch_size: int, rnd=lambda x: x,
                     act=lambda x: x, dtype: torch.dtype = torch.float32, fault: Optional[str] = None) -> np.ndarray:
    """Unit embeddings ``[len(waves), E]`` (f32) of whole utterances by the
    serving rules of :func:`perfbench.reference.embed.embed_utterances`
    (its buckets, windows and batches of ``batch_size`` rows with
    one-sample zero filler rows), through :class:`Net`."""
    net = Net(weights, cfg, rnd=rnd, act=act, dtype=dtype, fault=fault)
    fe = cfg["frontend"]
    groups: Dict[int, List[tuple]] = {}
    counts = np.zeros(len(waves), np.int64)
    for i, w in enumerate(waves):
        for start, n in window_lengths(len(w), buckets, overlap):
            groups.setdefault(bucket_for(n, buckets), []).append((i, start, n))
            counts[i] += 1
    acc = torch.zeros(len(waves), cfg["embedding_size"], dtype=torch.float32, device=device)
    for width, wins in sorted(groups.items()):
        for a in range(0, len(wins), batch_size):
            part = wins[a:a + batch_size]
            x = torch.zeros(batch_size, width, dtype=torch.float32, device=device)
            lengths = torch.ones(batch_size, dtype=torch.int64)
            for r, (i, start, n) in enumerate(part):
                x[r, :n] = torch.from_numpy(np.asarray(waves[i][start:start + n], np.float32)).to(device)
                lengths[r] = n
            mel, mask = log_mel(x, fe, lengths=lengths)
            emb = unit(net(mel, mask)).float()
            for r, (i, _, _) in enumerate(part):
                acc[i] += emb[r]
    out = unit(acc / torch.as_tensor(counts, device=device, dtype=torch.float32)[:, None])
    return out.cpu().numpy()
