"""MFA-Conformer (Zhang et al., Interspeech 2022, arXiv:2203.15249), port of
``titanet_tpu/models/conformer.py``, channels-last ``[B, T, C]``:

  subsample  Conv2d(1->d, 3x3, stride 2) + ReLU + Conv2d(d->d, 3x3) + ReLU
             over the mel map, then Dense(flatten freq -> dim): 1/2 frame
             rate ([B, T, 80] -> [B, ceil(T/2), dim])
  blocks     N x Conformer block (Gulati et al., arXiv:2005.08100):
               x += 1/2 FFN(LN x);  x += RelPosMHSA(LN x);
               x += ConvModule(LN x);  x += 1/2 FFN(LN x);  x = LN(x)
  MFA        concat every block's output [B, T', N*dim] -> LayerNorm
  pooling    attentive stats -> [B, 2*N*dim] -> BN
  head       Dense -> E -> BN

As in the JAX module: LayerNorm is flax's (epsilon 1e-6,
:class:`titanet_torch.ops.norm.LayerNorm`); the attention is plain
products in the compute dtype with an f32 softmax, padded KEYS excluded by
an additive -1e9 in f32 (a fully padded query row stays finite; it is
zeroed downstream); the relative-position scores are realigned by the
pad-and-reshape skew of :func:`rel_shift`, not a gather; the subsampling
uses fixed (1, 1) padding, so the frame mask halves as ``mask[:, ::2]``,
and flattens frequency-major, channel-minor; the conv module's depthwise
conv is a grouped library conv (:class:`~titanet_torch.ops.conv.GroupedConv1d`),
never the depthwise-backward kernel, as the JAX one is a plain ``nn.Conv``.
The pooling is the shared :class:`~titanet_torch.ops.pooling.AttentiveStatsPooling`,
so a bf16 step with no mask runs the pool kernels at ``C = N*dim``.
Dropout is :class:`~titanet_torch.ops.norm.FastDropout` with the step's
generator. A padded row's embedding equals the utterance's solo
embedding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from titanet_torch.models import common
from titanet_torch.ops.conv import Conv2d, GroupedConv1d
from titanet_torch.ops.dense import Dense
from titanet_torch.ops.norm import BatchNorm, FastDropout, LayerNorm
from titanet_torch.ops.pooling import AttentiveStatsPooling


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _zero_padded(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return x * mask[..., None].to(x.dtype)


def rel_pos_embedding(t: int, dim: int, device=None) -> torch.Tensor:
    """Sinusoidal embeddings of the relative distances ``T-1 .. -(T-1)``:
    row ``r`` encodes distance ``(t - 1) - r``. f32, ``[2T-1, dim]``."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)
    half = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    inv = torch.exp(half * (-math.log(10000.0) / dim))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = x[..., i, (T-1) - i + j]`` by pad + reshape.

    ``x`` is ``[B, H, T, 2T-1]`` of query-by-relative-distance scores (last
    axis indexed as :func:`rel_pos_embedding`); returns the ``[B, H, T, T]``
    query-by-key alignment. Pads, reshapes and slices only."""
    b, h, t, r = x.shape
    if r != 2 * t - 1:
        raise ValueError(f"rel_shift needs [..., T, 2T-1], got {tuple(x.shape)}")
    x = F.pad(x, (1, 0))  # [B, H, T, 2T]
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:, :]  # drop the pad column, now row-shifted
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPosSelfAttention(nn.Module):
    """Multi-head self-attention with Transformer-XL relative positions
    (arXiv:1901.02860): ``score = (q + u) k^T + skew((q + v) p^T)``, with
    learned biases ``pos_bias_u``/``pos_bias_v`` ``[H, dh]`` and ``p`` a
    bias-free projection of the sinusoidal relative-distance table."""

    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim must divide num_heads")
        self.num_heads, self.dtype = num_heads, dtype
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.pos = Dense(dim, dim, use_bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, dim // num_heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, dim // num_heads))
        self.out = Dense(dim, dim, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.pos_bias_u.zero_()
            self.pos_bias_v.zero_()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        heads = lambda y: y.reshape(b, t, h, dh).transpose(1, 2)  # noqa: E731  [B, H, T, dh]
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        p = self.pos(rel_pos_embedding(t, d, x.device).to(dt)).reshape(2 * t - 1, h, dh).permute(1, 2, 0)
        content = torch.matmul(q + self.pos_bias_u.to(dt)[None, :, None, :], k.transpose(-1, -2))
        pos_score = torch.matmul(q + self.pos_bias_v.to(dt)[None, :, None, :], p)  # [B, H, T, 2T-1]
        scores = (content + rel_shift(pos_score)).float() / math.sqrt(dh)
        if mask is not None:
            # exclude padded KEYS; padded query rows are zeroed downstream
            scores = scores + (1.0 - mask.float())[:, None, None, :] * -1e9
        alphas = torch.softmax(scores, dim=-1).to(dt)
        out = torch.matmul(alphas, v).transpose(1, 2).reshape(b, t, d)
        return self.out(out)


class ConformerConvModule(nn.Module):
    """Pointwise(2d) -> GLU -> depthwise(k) -> BN -> swish -> pointwise(d).
    Pads are zeroed before the depthwise conv and the BatchNorm statistics
    take ``mask`` in training."""

    def __init__(self, dim: int, kernel_size: int = 15, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pw1 = Dense(dim, 2 * dim, dtype=dtype)
        self.dw = GroupedConv1d(dim, dim, kernel_size, groups=dim, dtype=dtype)
        self.bn = BatchNorm(dim, dtype=dtype)
        self.pw2 = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a, g = self.pw1(x).chunk(2, dim=-1)
        x = _zero_padded(a * torch.sigmoid(g), mask)  # GLU
        x = self.bn(self.dw(x), mask=mask)  # the mask reaches BN in training only
        return self.pw2(_swish(x))


class ConformerBlock(nn.Module):
    """One Conformer block (arXiv:2005.08100 Fig. 1): FFN halves sandwich
    self-attention and the conv module, all pre-LayerNorm residuals."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 4,
        ff_hidden: int = 2048,
        conv_kernel: int = 15,
        dropout: float = 0.1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.ln_ff1 = LayerNorm(dim, dtype=dtype)
        self.ff1_in = Dense(dim, ff_hidden, dtype=dtype)
        self.ff1_out = Dense(ff_hidden, dim, dtype=dtype)
        self.ln_mhsa = LayerNorm(dim, dtype=dtype)
        self.mhsa = RelPosSelfAttention(dim, num_heads, dtype=dtype)
        self.ln_conv = LayerNorm(dim, dtype=dtype)
        self.conv = ConformerConvModule(dim, conv_kernel, dtype=dtype)
        self.ln_ff2 = LayerNorm(dim, dtype=dtype)
        self.ff2_in = Dense(dim, ff_hidden, dtype=dtype)
        self.ff2_out = Dense(ff_hidden, dim, dtype=dtype)
        self.ln_out = LayerNorm(dim, dtype=dtype)
        self.dropout = FastDropout(dropout)

    def _ffn(self, x, name, generator):
        x = _swish(getattr(self, f"{name}_in")(x))
        return getattr(self, f"{name}_out")(self.dropout(x, generator))

    def forward(self, x, mask=None, generator=None):
        drop = lambda y: self.dropout(y, generator)  # noqa: E731
        x = x + 0.5 * drop(self._ffn(self.ln_ff1(x), "ff1", generator))
        x = x + drop(self.mhsa(self.ln_mhsa(x), mask=mask))
        x = x + drop(self.conv(self.ln_conv(x), mask=mask))
        x = x + 0.5 * drop(self._ffn(self.ln_ff2(x), "ff2", generator))
        return self.ln_out(x)


class ConvSubsampling(nn.Module):
    """1/2-rate conv subsampling over the mel map (paper §2.1): two 3x3
    convs (the first stride 2) on ``[B, T, F, 1]`` with fixed (1, 1)
    padding, then Dense over the flattened frequency-major (freq x
    channels) axis."""

    def __init__(self, n_mels: int = 80, dim: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv2d(1, dim, 3, stride=2, padding=1, dtype=dtype)
        self.conv2 = Conv2d(dim, dim, 3, stride=1, padding=1, dtype=dtype)
        self.proj = Dense(-(-n_mels // 2) * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = torch.relu(self.conv1(x[..., None]))  # [B, T', F', dim]
        if mask is not None:
            # zero invalid frames so conv2 sees what the solo forward's zero padding gives
            h = h * mask[:, ::2, None, None].to(h.dtype)
        h = torch.relu(self.conv2(h))
        b, t2, f2, c = h.shape
        return self.proj(h.reshape(b, t2, f2 * c))


class MfaConformer(nn.Module):
    """Full MFA-Conformer: mel ``[B, T, n_mels]`` -> raw embedding ``[B, E]``,
    the calling convention of :class:`titanet_torch.models.TitaNet`
    (``generator`` feeds the dropout draws in training)."""

    def __init__(
        self,
        n_mels: int = 80,
        num_blocks: int = 6,
        dim: int = 256,
        num_heads: int = 4,
        ff_hidden: int = 2048,
        conv_kernel: int = 15,
        dropout: float = 0.1,
        attention_hidden_size: int = 128,
        embedding_size: int = 192,
        dtype: Optional[torch.dtype] = None,
        axis_name: Optional[str] = None,
    ):
        super().__init__()
        self.embedding_size, self.dtype, self.num_blocks = embedding_size, dtype, num_blocks
        self.subsample = ConvSubsampling(n_mels, dim, dtype=dtype)
        for i in range(num_blocks):
            self.add_module(
                f"block_{i}",
                ConformerBlock(dim, num_heads, ff_hidden, conv_kernel, dropout, dtype=dtype),
            )
        width = num_blocks * dim
        self.mfa_norm = LayerNorm(width, dtype=dtype)
        self.pool = AttentiveStatsPooling(width, attention_hidden_size, dtype=dtype)
        self.pool_norm = BatchNorm(2 * width, dtype=dtype)
        self.linear = Dense(2 * width, embedding_size, dtype=dtype)
        self.linear_norm = BatchNorm(embedding_size, dtype=dtype)
        common.set_axis_name(self, axis_name)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        common.reset_parameters(self, generator)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        h = self.subsample(_zero_padded(x, mask), mask=mask)
        mask2 = mask[:, ::2] if mask is not None else None
        h = _zero_padded(h, mask2)
        outs = []
        for i in range(self.num_blocks):
            h = getattr(self, f"block_{i}")(h, mask=mask2, generator=generator)
            outs.append(h)
        h = self.mfa_norm(torch.cat(outs, dim=-1))  # MFA [B, T', N*dim]
        pooled = self.pool_norm(self.pool(_zero_padded(h, mask2), mask=mask2))
        return self.linear_norm(self.linear(pooled))


def get_conformer(
    num_blocks: int = 6,
    dim: int = 256,
    num_heads: int = 4,
    ff_hidden: int = 2048,
    conv_kernel: int = 15,
    dropout: float = 0.1,
    embedding_size: int = 192,
    attention_hidden_size: int = 128,
    n_mels: int = 80,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    axis_name: Optional[str] = None,
) -> MfaConformer:
    """Paper-scale defaults (~20.5M params): 6 blocks, dim 256, 4 heads, FF
    2048, conv kernel 15 (arXiv:2203.15249 §3.2); in eval mode on
    ``device``, weights drawn from ``generator`` (default: seeded with 0)."""
    model = MfaConformer(
        n_mels=n_mels, num_blocks=num_blocks, dim=dim, num_heads=num_heads, ff_hidden=ff_hidden,
        conv_kernel=conv_kernel, dropout=dropout, attention_hidden_size=attention_hidden_size,
        embedding_size=embedding_size, dtype=dtype, axis_name=axis_name,
    )
    return common.finish(model, device, generator)
