"""Plain ECAPA-TDNN (Desplanques, Thienpondt and Demuynck, Interspeech 2020,
arXiv:2005.07143) in evaluation, float32, as a function of a dict of named
tensors: the reference the port's served ECAPA is held to.

  layer1   conv(n_mels -> C, k=5) -> relu -> BN
  layer2-4 SE-Res2Block(C, k=3, dilation 2 / 3 / 4, scale 8): 1x1 conv ->
           relu -> BN; Res2 dilated conv (y_1 = x_1, y_i = K_i(x_i + y_{i-1}))
           -> relu -> BN; 1x1 conv -> relu -> BN; squeeze-excitation; plus
           the block's input
  MFA      concat(layer2..4) [B, T, 3C] -> 1x1 conv -> relu [B, T, 1536]
  pooling  channel- and context-dependent attentive statistics: e =
           W2 tanh(W1 [h, mean, std] + b1) + b2, the mean and std over the
           valid frames, a softmax over them a channel, the weighted mean
           and std -> [B, 3072] -> BN
  head     linear(3072 -> E) -> BN

Departures from the paper, as the port reads it: 80 log-mel bands where the
paper takes 80 MFCCs; the Res2 groups' convolutions without a ReLU and BN of
their own, one ReLU and BN after their concat; the squeeze-excitation's two
linear layers without biases; the attention's hidden layer without a
BatchNorm; an MFA width of 1536. ``mask`` ([B, T], 1 valid) keeps padded
frames out of every statistic, and activations are zeroed at padded frames
after each convolution. BatchNorm takes the running statistics, eps 1e-5.

The tensors carry the port's state-dict names. Plain torch only: nothing
of ``titanet_torch``, the JAX package or JAX is imported, and TF32 is off
for float32 products.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
POOL_EPS = 1e-6


def _zero_padded(x, mask):
    return x if mask is None else x * mask[..., None]


def _conv(p, prefix, x, dilation=1):
    w, b = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    pad = dilation * (w.shape[-1] - 1) // 2
    return F.conv1d(x.transpose(1, 2), w, b, padding=pad, dilation=dilation).transpose(1, 2)


def _bn(p, prefix, x):
    return ((x - p[f"{prefix}.running_mean"]) * torch.rsqrt(p[f"{prefix}.running_var"] + BN_EPS)
            * p[f"{prefix}.weight"] + p[f"{prefix}.bias"])


def _conv_relu_bn(p, prefix, x, mask, dilation=1):
    return _zero_padded(_bn(p, f"{prefix}.norm", torch.relu(_conv(p, f"{prefix}.conv", x, dilation))), mask)


def _time_mean(x, mask):
    if mask is None:
        return x.mean(dim=1)
    m = mask[..., None]
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def _block(p, prefix, x, mask, dilation, scale):
    y = _conv_relu_bn(p, f"{prefix}.conv_in", x, mask)
    width = y.shape[-1] // scale
    outs, prev = [y[..., :width]], None
    for i in range(1, scale):
        xi = y[..., i * width:(i + 1) * width]
        if prev is not None:
            xi = xi + prev
        prev = _zero_padded(_conv(p, f"{prefix}.res2.conv_{i}", xi, dilation), mask)
        outs.append(prev)
    y = _zero_padded(_bn(p, f"{prefix}.res2_norm", torch.relu(torch.cat(outs, dim=-1))), mask)
    y = _conv_relu_bn(p, f"{prefix}.conv_out", y, mask)
    s = torch.relu(_time_mean(y, mask) @ p[f"{prefix}.se.fc1.weight"].t())
    gate = torch.sigmoid(s @ p[f"{prefix}.se.fc2.weight"].t())
    return x + y * gate[:, None, :]


def context_pool(p, h, mask):
    """The attentive statistics with the context ``[B, 2C]``: ``h [B, T, C]``
    -> ``[B, 2C]``."""
    c = h.shape[-1]
    mean = _time_mean(h, mask)[:, None, :]
    var = _time_mean((h - mean) ** 2, mask)[:, None, :]
    std = torch.sqrt(torch.clamp(var, min=POOL_EPS))
    w1, b1 = p["pool.in_linear.weight"], p["pool.in_linear.bias"]
    u = torch.tanh(h @ w1[:, :c].t() + mean @ w1[:, c:2 * c].t() + std @ w1[:, 2 * c:].t() + b1)
    e = u @ p["pool.out_linear.weight"].t() + p["pool.out_linear.bias"]
    if mask is not None:
        e = e.masked_fill(mask[..., None] == 0, float("-inf"))
    alpha = torch.softmax(e, dim=1)
    am = (alpha * h).sum(dim=1)
    astd = torch.sqrt(torch.clamp((alpha * h * h).sum(dim=1) - am * am, min=POOL_EPS))
    return torch.cat([am, astd], dim=-1)


@torch.no_grad()
def forward(p: Dict[str, torch.Tensor], mel: torch.Tensor, mask: Optional[torch.Tensor] = None,
            dilations=(2, 3, 4), scale: int = 8) -> torch.Tensor:
    """``mel [B, T, n_mels]`` -> raw embeddings ``[B, E]`` (not unit norm)."""
    mel, mask = mel.float(), None if mask is None else mask.float()
    h = _conv_relu_bn(p, "layer1", _zero_padded(mel, mask), mask)
    outs = []
    for i, d in enumerate(dilations):
        h = _block(p, f"layer{i + 2}", h, mask, d, scale)
        outs.append(h)
    h = torch.relu(_conv(p, "mfa_conv", torch.cat(outs, dim=-1)))
    pooled = _bn(p, "pool_norm", context_pool(p, h, mask))
    return _bn(p, "linear_norm", pooled @ p["linear.weight"].t() + p["linear.bias"])
