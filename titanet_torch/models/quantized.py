"""Int8 quantized TitaNet serving path (port of
``titanet_tpu/models/quantized.py``).

Weight-and-activation int8 inference for the encoder's pointwise products:
the sub-block pointwise convs, the mega-block skip convs and the epilog.
Depthwise taps, SE and the decoder stay f32.

Scheme (symmetric linear quantization, post-training):

- Weights: BatchNorm (eval) is folded into the preceding pointwise weight
  and bias first, then each OUTPUT channel gets its own scale
  ``s_j = max_i |W'[i, j]| / 127``.
- Activations: dynamic per-row scales ``r_b = max_c |x[b, c]| / 127``.
- Accumulation: ``int8 @ int8 -> int32``, dequantized as
  ``y = acc * r_b * s_j + bias'``.

The int8 product is a library call (``torch._int_mm``), as the JAX package
leaves it to its compiler; everything else mirrors
``titanet_apply_fused`` op for op (pad-included SE statistics unless
masked).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from titanet_torch.models.fused_inference import _bn_fold, _masked_mean
from titanet_torch.models.titanet import Decoder, TitaNet
from titanet_torch.ops.conv import conv1d_same
from titanet_torch.ops.pooling import attentive_stats


class QuantLinear(NamedTuple):
    """Per-output-channel int8 weight: y = (xq @ w_q) * (r_row * scale) + bias."""

    w_q: torch.Tensor  # [C_in, C_out] int8
    scale: torch.Tensor  # [C_out] f32 (includes folded BN scale)
    bias: torch.Tensor  # [C_out] f32 (includes folded BN shift)


def _quantize_weight(w: torch.Tensor, bias: torch.Tensor) -> QuantLinear:
    """``w [C_in, C_out]``."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return QuantLinear(w_q.contiguous(), scale, bias.float())


def _fold_then_quantize(w, b, bn) -> QuantLinear:
    """Fold eval-mode BatchNorm ``bn`` into ``(w [C_in, C_out], b)``, then
    quantize per output channel."""
    bn_scale, bn_shift = _bn_fold(bn)
    w = w.float() * bn_scale[None, :]
    b = b.float() * bn_scale + bn_shift
    return _quantize_weight(w, b)


def _int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``[M, K] int8 @ [K, N] int8 -> [M, N] int32``, exact. On the card
    ``torch._int_mm`` wants more than 16 rows and K, N that are multiples
    of 8: operands that fall short are zero-padded, which leaves the
    integers unchanged."""
    if x_q.device.type != "cuda":
        return torch._int_mm(x_q, w_q)
    m, k = x_q.shape
    n = w_q.shape[1]
    pm, pk, pn = max(32 - m, 0), -k % 8, -n % 8
    if pm or pk:
        x_q = F.pad(x_q, (0, pk, 0, pm))
    if pk or pn:
        w_q = F.pad(w_q, (0, pn, 0, pk))
    return torch._int_mm(x_q.contiguous(), w_q.contiguous())[:m, :n]


def quantized_matmul(x: torch.Tensor, q: QuantLinear, relu: bool = False) -> torch.Tensor:
    """``x [..., C_in]`` (float) -> ``[..., C_out]`` (f32). Dynamic per-row int8."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).float()
    r = torch.clamp(x2.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    x_q = torch.clamp(torch.round(x2 / r), -127, 127).to(torch.int8)
    acc = _int8_product(x_q, q.w_q)
    y = acc.float() * (r * q.scale[None, :]) + q.bias[None, :]
    if relu:
        y = torch.relu(y)
    return y.reshape(shape[:-1] + (q.w_q.shape[1],))


class QuantMegaBlock(NamedTuple):
    dw_w: torch.Tensor  # [S, k, C] depthwise taps (f32)
    dw_b: torch.Tensor  # [S, C]
    pw: tuple  # S x QuantLinear (pointwise + folded sub-block BN)
    se_fc1: torch.Tensor  # [C, C/r] (in, out)
    se_fc2: torch.Tensor  # [C/r, C]
    skip: QuantLinear  # skip pointwise + folded skip BN


@dataclass(frozen=True)
class QuantTitaNet:
    """Quantized parameter tree (build once with :func:`quantize_titanet`)."""

    prolog_kernel: torch.Tensor  # [H, n_mels, k] (f32: tiny share of the work)
    prolog_bias: torch.Tensor
    prolog_bn: Tuple[torch.Tensor, torch.Tensor]  # (scale, shift)
    mega_blocks: tuple  # N x QuantMegaBlock
    epilog: QuantLinear  # [H, 1536] k=1 conv + folded BN
    decoder: Decoder  # the model's small f32 tail, used as it is
    n_sub_blocks: int
    kernel_size: int
    simple_pool: bool


@torch.no_grad()
def quantize_titanet(model: TitaNet) -> QuantTitaNet:
    """Extract, fold and quantize a TitaNet's parameters (run once), on the
    model's device. The encoder's tensors are the tree's own; the decoder
    is the model's module."""
    enc = model.encoder
    blocks = []
    for i in range(model.n_mega_blocks):
        mega = getattr(enc, f"mega_block_{i}")
        dw_w, dw_b, pw = [], [], []
        for s in range(model.n_sub_blocks):
            blk = getattr(mega, f"sub_block_{s}")
            dw_w.append(blk.conv.depthwise.weight[:, 0, :].t())  # [k, C]
            dw_b.append(blk.conv.depthwise.bias)
            pw.append(
                _fold_then_quantize(
                    blk.conv.pointwise.weight[:, :, 0].t(), blk.conv.pointwise.bias, blk.norm
                )
            )
        skip = _fold_then_quantize(
            mega.skip_conv.weight[:, :, 0].t(), mega.skip_conv.bias, mega.skip_norm
        )
        blocks.append(
            QuantMegaBlock(
                dw_w=torch.stack(dw_w).contiguous(), dw_b=torch.stack(dw_b), pw=tuple(pw),
                se_fc1=mega.se.fc1.weight.t().contiguous(), se_fc2=mega.se.fc2.weight.t().contiguous(),
                skip=skip,
            )
        )
    epilog = _fold_then_quantize(
        enc.epilog.conv.weight[:, :, 0].t(), enc.epilog.conv.bias, enc.epilog.norm
    )
    return QuantTitaNet(
        prolog_kernel=enc.prolog.conv.weight.clone(),
        prolog_bias=enc.prolog.conv.bias.clone(),
        prolog_bn=_bn_fold(enc.prolog.norm),
        mega_blocks=tuple(blocks),
        epilog=epilog,
        decoder=model.decoder,
        n_sub_blocks=model.n_sub_blocks,
        kernel_size=model.mega_block_kernel_size,
        simple_pool=model.simple_pool,
    )


def _depthwise(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Same-padding K-tap depthwise conv as K shifted multiply-adds."""
    k = taps.shape[0]
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    t = x.shape[1]
    acc = xp[:, 0:t, :] * taps[0]
    for j in range(1, k):
        acc = acc + xp[:, j : j + t, :] * taps[j]
    return acc + bias


@torch.no_grad()
def titanet_apply_quantized(
    q: QuantTitaNet, mel: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``mel [B, T, n_mels]`` -> raw embeddings ``[B, E]`` (int8 encoder products)."""
    # prolog (k=3, n_mels -> H): plain conv + folded BN + relu
    x = conv1d_same(mel.float(), q.prolog_kernel, q.prolog_bias)
    x = torch.relu(x * q.prolog_bn[0] + q.prolog_bn[1])

    for blk in q.mega_blocks:
        y = x
        for s in range(q.n_sub_blocks):
            y = _depthwise(y, blk.dw_w[s], blk.dw_b[s])
            y = quantized_matmul(y, blk.pw[s], relu=True)
        # SE: pad-included global mean unless masked
        squeezed = _masked_mean(y, mask)
        e = torch.relu(squeezed @ blk.se_fc1)
        e = torch.sigmoid(e @ blk.se_fc2)
        y = y * e[:, None, :]
        skip = quantized_matmul(x, blk.skip)
        x = torch.relu(skip + y)

    x = quantized_matmul(x, q.epilog, relu=True)

    # decoder: small f32 tail, identical to models/fused_inference.py
    dec = q.decoder
    if q.simple_pool:
        pooled = F.linear(_masked_mean(x, mask), dec.pool.linear.weight, dec.pool.linear.bias)
    else:
        w_in, w_out = dec.pool.in_linear, dec.pool.out_linear
        e = torch.tanh(F.linear(x, w_in.weight, w_in.bias))
        e = F.linear(e, w_out.weight, w_out.bias)
        pooled = attentive_stats(x, e, mask=mask)
        scale, shift = _bn_fold(dec.pool_norm)
        pooled = pooled * scale + shift
    emb = F.linear(pooled, dec.linear.weight, dec.linear.bias)
    scale, shift = _bn_fold(dec.linear_norm)
    return emb * scale + shift
