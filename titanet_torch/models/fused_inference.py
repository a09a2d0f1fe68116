"""Fused TitaNet inference path (port of
``titanet_tpu/models/fused_inference.py``).

Replicates ``TitaNet.forward`` in eval mode with each mega-block's
sub-block chain in ONE launch of the fused kernel
(:mod:`titanet_torch.ops.kernels.megablock`) and everything else (prolog,
SE, skip, epilog, decoder) as plain torch ops on the model's parameters.
The activation stream runs in ``model.dtype``; BatchNorm is a folded f32
affine; the decoder pools with the plain :func:`attentive_stats` (this
path does not route to the pooling kernel). Returns the raw embedding.

It agrees with ``TitaNet.forward`` except in the first and last
``(S-1)*pad`` rows of every mega-block, where the kernel evaluates the
halo rows instead of re-zeroing them (see the kernel's module).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from titanet_torch.models.titanet import ConvBlock1d, MegaBlock, TitaNet
from titanet_torch.ops.conv import conv1d_same
from titanet_torch.ops.kernels.megablock import fold_bn, fused_sub_blocks
from titanet_torch.ops.norm import BatchNorm
from titanet_torch.ops.pooling import attentive_stats


def _bn_fold(bn: BatchNorm):
    return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.epsilon)


def _bn_affine(x: torch.Tensor, bn: BatchNorm) -> torch.Tensor:
    """Eval-mode BatchNorm as a folded affine: computed in f32, returned in
    ``x``'s dtype so a bf16 activation stream stays bf16."""
    scale, shift = _bn_fold(bn)
    return (x.float() * scale + shift).to(x.dtype)


def _conv_block_eval(x: torch.Tensor, block: ConvBlock1d) -> torch.Tensor:
    """ConvBlock1d (non-depthwise) in eval mode: conv, folded BN, relu."""
    w, b = block.conv.weight.to(x.dtype), block.conv.bias.to(x.dtype)
    if w.shape[-1] == 1:
        x = F.linear(x, w[:, :, 0], b)
    else:
        x = conv1d_same(x, w, b)
    return torch.relu(_bn_affine(x, block.norm))


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def _stack_mega_params(mega: MegaBlock, n_sub: int, dtype: Optional[torch.dtype] = None):
    """Pack a mega-block's sub-chain parameters for the fused kernel:
    ``(dw_w [S, k, C], dw_b [S, C], pw_w [S, C, C], pw_b [S, C],
    bn [S, 2, C])``. ``dtype`` (the activation dtype) applies to the
    pointwise weights only; the taps, biases and folded BN vectors stay
    f32. The pack is kept on the module (``_fused_packed``, one entry per
    dtype) and rebuilt when a parameter or a running statistic has changed
    or moved."""
    subs = [getattr(mega, f"sub_block_{i}") for i in range(n_sub)]
    sources = []
    for blk in subs:
        dw, pw, norm = blk.conv.depthwise, blk.conv.pointwise, blk.norm
        sources += [dw.weight, dw.bias, pw.weight, pw.bias,
                    norm.weight, norm.bias, norm.running_mean, norm.running_var]
    stamp = tuple((t.data_ptr(), t._version) for t in sources)
    cache = mega.__dict__.setdefault("_fused_packed", {})
    cached = cache.get(dtype)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    with torch.no_grad():
        dw_w = torch.stack([b.conv.depthwise.weight[:, 0, :].t() for b in subs])  # [S, k, C]
        dw_b = torch.stack([b.conv.depthwise.bias for b in subs])
        pw_w = torch.stack([b.conv.pointwise.weight[:, :, 0].t() for b in subs])  # (in, out)
        if dtype is not None:
            pw_w = pw_w.to(dtype)
        pw_b = torch.stack([b.conv.pointwise.bias for b in subs])
        bn = torch.stack([torch.stack(_bn_fold(b.norm)) for b in subs])
        packed = tuple(t.detach().contiguous() for t in (dw_w, dw_b, pw_w, pw_b, bn))
    cache[dtype] = (stamp, packed)
    return packed


@torch.no_grad()
def titanet_apply_fused(
    model: TitaNet, mel: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``mel [B, T, n_mels]`` -> raw embeddings ``[B, E]`` (inference). The
    model's parameters are read as they are; ``mel`` must be on their
    device."""
    enc, dec = model.encoder, model.decoder
    dt = model.dtype if model.dtype is not None else mel.dtype
    x = _conv_block_eval(mel.to(dt), enc.prolog)
    for i in range(model.n_mega_blocks):
        mega = getattr(enc, f"mega_block_{i}")
        packed = _stack_mega_params(mega, model.n_sub_blocks, dtype=dt)
        y = fused_sub_blocks(x.contiguous(), *packed, kernel_size=model.mega_block_kernel_size)
        # SE: mean over T (pad-included unless masked)
        squeezed = _masked_mean(y, mask)
        e = torch.relu(F.linear(squeezed, mega.se.fc1.weight.to(y.dtype)))
        e = torch.sigmoid(F.linear(e, mega.se.fc2.weight.to(y.dtype)))
        y = y * e[:, None, :]
        # skip: pointwise conv + BN
        skip = F.linear(
            x, mega.skip_conv.weight[:, :, 0].to(x.dtype), mega.skip_conv.bias.to(x.dtype)
        )
        skip = _bn_affine(skip, mega.skip_norm)
        x = torch.relu(skip + y)

    x = _conv_block_eval(x, enc.epilog)

    if model.simple_pool:
        lin = dec.pool.linear
        pooled = F.linear(_masked_mean(x, mask).to(lin.weight.dtype), lin.weight, lin.bias)
    else:
        w_in, w_out = dec.pool.in_linear, dec.pool.out_linear
        e = torch.tanh(F.linear(x, w_in.weight.to(x.dtype), w_in.bias.to(x.dtype)))
        e = F.linear(e, w_out.weight.to(x.dtype), w_out.bias.to(x.dtype))
        pooled = attentive_stats(x, e, mask=mask)
        pooled = _bn_affine(pooled, dec.pool_norm)
    emb = F.linear(pooled, dec.linear.weight.to(pooled.dtype), dec.linear.bias.to(pooled.dtype))
    return _bn_affine(emb, dec.linear_norm)
