"""TitaNet (Koluguri et al., arXiv:2110.04410), training and inference
forward (port of ``titanet_tpu/models/titanet.py``), channels-last
``[B, T, C]``:

  Encoder: prolog ConvBlock(n_mels->H, k=3)
           -> N x MegaBlock(3 depthwise sub-blocks + SE, conv-BN skip)
           -> epilog ConvBlock(H->1536, k=1)
  Decoder: AttentiveStatsPooling -> BN -> Linear(3072->E) -> BN

Module attribute names follow the JAX parameter tree
(``encoder.mega_block_3.sub_block_0.conv.depthwise``,
``decoder.pool.in_linear``, ...), so
:func:`titanet_torch.utils.weights.load_jax_variables` maps one onto the
other by path. The model takes ``[B, T, n_mels]`` and returns raw
embeddings ``[B, E]``; ``mask`` (``[B, T]``) makes SE and pooling ignore
padded frames.

``model.train()`` selects the training forward: BatchNorm normalizes with
batch statistics (masked by ``mask`` when given) and publishes its batch
moments (:func:`titanet_torch.ops.norm.ema_update_batch_stats` folds them
in), and dropout is active at the JAX package's sites: after each
sub-block's relu and after each mega-block's ``relu(skip + y)``, none in
the prolog or the epilog (4 sites a mega-block). Its draws come from the
``generator`` passed to :meth:`TitaNet.forward`. In eval mode dropout is
the identity and BatchNorm uses its running statistics.

When the model is bf16 and there is no mask, the epilog's BatchNorm apply
and relu are folded into the fused pooling kernel, in both modes (in
training from the batch statistics).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from titanet_torch._device import resolve_device
from titanet_torch.models import common
from titanet_torch.ops.conv import DepthwiseSeparableConv1d, SamePadConv1d
from titanet_torch.ops.dense import Dense
from titanet_torch.ops.kernels.pool import kernel_supports
from titanet_torch.ops.norm import BatchNorm, FastDropout
from titanet_torch.ops.pooling import AttentiveStatsPooling, SimplePooling
from titanet_torch.ops.se import SqueezeExcitation

TARGET_PARAMS = {"s": 6.4, "m": 13.4, "l": 25.3}


class ConvBlock1d(nn.Module):
    """conv -> BatchNorm -> relu -> dropout."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        depthwise: bool = False,
        dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        conv_cls = DepthwiseSeparableConv1d if depthwise else SamePadConv1d
        self.conv = conv_cls(in_features, features, kernel_size, dtype=dtype)
        self.norm = BatchNorm(features, dtype=dtype)
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, mask=None, defer_apply: bool = False, generator=None):
        """``mask`` reaches the BatchNorm statistics in training only. With
        ``defer_apply`` return ``(conv(x), a, c)``: the BatchNorm apply and
        the relu are left to the consumer as ``relu(a*h + c)``."""
        x = self.conv(x)
        if defer_apply:
            if self.dropout.rate:
                raise ValueError("defer_apply needs a block without dropout")
            a, c = self.norm(x, mask=mask, return_scale_shift=True)
            return x, a, c
        return self.dropout(torch.relu(self.norm(x, mask=mask)), generator)


class MegaBlock(nn.Module):
    """3 depthwise ConvBlocks -> SE, summed with a 1x1-conv+BN skip branch,
    then ReLU and dropout."""

    def __init__(
        self,
        features: int,
        kernel_size: int,
        n_sub_blocks: int = 3,
        se_reduction: int = 16,
        dropout: float = 0.5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.n_sub_blocks = n_sub_blocks
        for i in range(n_sub_blocks):
            self.add_module(
                f"sub_block_{i}",
                ConvBlock1d(features, features, kernel_size, depthwise=True,
                            dropout=dropout, dtype=dtype),
            )
        self.se = SqueezeExcitation(features, se_reduction, dtype=dtype)
        self.skip_conv = SamePadConv1d(features, features, 1, dtype=dtype)
        self.skip_norm = BatchNorm(features, dtype=dtype)
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        y = x
        for i in range(self.n_sub_blocks):
            y = getattr(self, f"sub_block_{i}")(y, mask=mask, generator=generator)
        y = self.se(y, mask=mask)
        skip = self.skip_norm(self.skip_conv(x), mask=mask)
        return self.dropout(torch.relu(skip + y), generator)


class Encoder(nn.Module):
    """Prolog -> N MegaBlocks -> epilog: ``[B, T, n_mels] -> [B, T, output_size]``."""

    def __init__(
        self,
        n_mels: int,
        n_mega_blocks: int,
        n_sub_blocks: int = 3,
        hidden_size: int = 256,
        output_size: int = 1536,
        mega_block_kernel_size: int = 3,
        prolog_kernel_size: int = 3,
        epilog_kernel_size: int = 1,
        se_reduction: int = 16,
        dropout: float = 0.5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.n_mega_blocks = n_mega_blocks
        self.prolog = ConvBlock1d(n_mels, hidden_size, prolog_kernel_size, dtype=dtype)
        for i in range(n_mega_blocks):
            self.add_module(
                f"mega_block_{i}",
                MegaBlock(hidden_size, mega_block_kernel_size, n_sub_blocks, se_reduction,
                          dropout, dtype),
            )
        self.epilog = ConvBlock1d(hidden_size, output_size, epilog_kernel_size, dtype=dtype)

    def forward(self, x, mask=None, defer_epilog: bool = False, generator=None):
        x = self.prolog(x, mask=mask)
        for i in range(self.n_mega_blocks):
            x = getattr(self, f"mega_block_{i}")(x, mask=mask, generator=generator)
        return self.epilog(x, mask=mask, defer_apply=defer_epilog)


class Decoder(nn.Module):
    """Attentive stats pooling -> BN -> Linear -> BN: ``[B, T, C] -> [B, E]``.
    With ``simple_pool``: average pool + Linear(C -> 2C) -> Linear -> BN
    (no ``pool_norm``)."""

    def __init__(
        self,
        channels: int = 1536,
        embedding_size: int = 192,
        attention_hidden_size: int = 128,
        simple_pool: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.simple_pool = simple_pool
        if simple_pool:
            self.pool = SimplePooling(channels, dtype=dtype)
        else:
            self.pool = AttentiveStatsPooling(channels, attention_hidden_size, dtype=dtype)
            self.pool_norm = BatchNorm(2 * channels, dtype=dtype)
        self.linear = Dense(2 * channels, embedding_size, dtype=dtype)
        self.linear_norm = BatchNorm(embedding_size, dtype=dtype)

    def forward(self, x, mask=None, prescale=None, preshift=None):
        if self.simple_pool:
            pooled = self.pool(x, mask=mask)
        else:
            pooled = self.pool_norm(
                self.pool(x, mask=mask, prescale=prescale, preshift=preshift)
            )
        return self.linear_norm(self.linear(pooled))


class TitaNet(nn.Module):
    """Full TitaNet: ``[B, T, n_mels] -> [B, E]`` raw embeddings. Use
    :func:`titanet_torch.models.l2_normalize` for unit-norm embeddings."""

    def __init__(
        self,
        n_mels: int = 80,
        n_mega_blocks: int = 17,
        n_sub_blocks: int = 3,
        encoder_hidden_size: int = 256,
        encoder_output_size: int = 1536,
        embedding_size: int = 192,
        mega_block_kernel_size: int = 3,
        prolog_kernel_size: int = 3,
        epilog_kernel_size: int = 1,
        attention_hidden_size: int = 128,
        se_reduction: int = 16,
        simple_pool: bool = False,
        dropout: float = 0.5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.n_mega_blocks = n_mega_blocks
        self.n_sub_blocks = n_sub_blocks
        self.mega_block_kernel_size = mega_block_kernel_size
        self.simple_pool = simple_pool
        self.embedding_size = embedding_size
        self.encoder_output_size = encoder_output_size
        self.attention_hidden_size = attention_hidden_size
        self.dtype = dtype
        self.encoder = Encoder(
            n_mels, n_mega_blocks, n_sub_blocks, encoder_hidden_size, encoder_output_size,
            mega_block_kernel_size, prolog_kernel_size, epilog_kernel_size, se_reduction,
            dropout, dtype,
        )
        self.decoder = Decoder(
            encoder_output_size, embedding_size, attention_hidden_size, simple_pool, dtype
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter in module order from ``generator``."""
        common.reset_parameters(self, generator)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``generator`` feeds the dropout draws in training mode."""
        # Fused-decoder eligibility: the pooling kernel absorbs the epilog
        # BN apply + relu, so the post-BN [B, T, C] activation never exists.
        dt = self.dtype or x.dtype
        fuse = not self.simple_pool and mask is None and kernel_supports(
            self.encoder_output_size, self.attention_hidden_size, x.shape[1], dt
        )
        enc = self.encoder(x, mask=mask, defer_epilog=fuse, generator=generator)
        if fuse:
            enc, prescale, preshift = enc
        else:
            prescale = preshift = None
        return self.decoder(enc, mask=mask, prescale=prescale, preshift=preshift)


_SIZE_PRESETS = {
    "s": dict(encoder_hidden_size=256, mega_block_kernel_size=3),
    "m": dict(encoder_hidden_size=512, mega_block_kernel_size=7),
    "l": dict(encoder_hidden_size=1024, mega_block_kernel_size=11),
}


def get_titanet(
    embedding_size: int = 192,
    n_mels: int = 80,
    n_mega_blocks: Optional[int] = None,
    model_size: str = "s",
    attention_hidden_size: int = 128,
    simple_pool: bool = False,
    dropout: float = 0.5,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> TitaNet:
    """Size-preset constructor, in eval mode on ``device`` (``model.train()``
    selects the training forward). Weights are
    drawn from ``generator`` (default: a generator seeded with 0). If
    ``n_mega_blocks`` is None, picks the count whose parameter total is
    closest to the paper target."""
    size = model_size.lower()
    if size not in _SIZE_PRESETS:
        raise ValueError(f"Unsupported model size {model_size!r}")
    resolve_device(device)  # before the search below: no card, no model
    if n_mega_blocks is None:
        n_mega_blocks = find_n_mega_blocks(
            embedding_size, n_mels, size, attention_hidden_size=attention_hidden_size,
            simple_pool=simple_pool,
        )
    model = TitaNet(
        n_mels=n_mels,
        n_mega_blocks=n_mega_blocks,
        embedding_size=embedding_size,
        attention_hidden_size=attention_hidden_size,
        simple_pool=simple_pool,
        dropout=dropout,
        dtype=dtype,
        **_SIZE_PRESETS[size],
    )
    return common.finish(model, device, generator)


def titanet_param_count(
    n_mels: int = 80,
    n_mega_blocks: int = 17,
    n_sub_blocks: int = 3,
    hidden: int = 256,
    output_size: int = 1536,
    embedding_size: int = 192,
    kernel: int = 3,
    prolog_kernel: int = 3,
    epilog_kernel: int = 1,
    attention_hidden: int = 128,
    se_reduction: int = 16,
    simple_pool: bool = False,
) -> int:
    """Closed-form parameter count, exact vs
    ``sum(p.numel() for p in model.parameters())``."""
    h, o, e, a = hidden, output_size, embedding_size, attention_hidden
    prolog = prolog_kernel * n_mels * h + h + 2 * h
    sub = (kernel * h + h) + (h * h + h) + 2 * h  # dw-sep + BN
    se = 2 * h * (h // se_reduction)
    skip = h * h + h + 2 * h
    mega = n_sub_blocks * sub + se + skip
    epilog = epilog_kernel * h * o + o + 2 * o
    if simple_pool:
        pool = o * (2 * o) + 2 * o
    else:
        pool = (o * a + a) + (a * o + o) + 2 * (2 * o)  # attention + BN(2o)
    decoder = pool + (2 * o * e + e) + 2 * e
    return prolog + n_mega_blocks * mega + epilog + decoder


def find_n_mega_blocks(
    embedding_size: int = 192,
    n_mels: int = 80,
    model_size: str = "s",
    trials=None,
    attention_hidden_size: int = 128,
    simple_pool: bool = False,
) -> int:
    """n_mega_blocks whose parameter count is closest to the paper target."""
    trials = trials if trials is not None else range(1, 20)
    target = TARGET_PARAMS[model_size.lower()]
    preset = _SIZE_PRESETS[model_size.lower()]
    best, best_dist = None, float("inf")
    for n in trials:
        params_m = titanet_param_count(
            n_mels=n_mels,
            n_mega_blocks=n,
            hidden=preset["encoder_hidden_size"],
            kernel=preset["mega_block_kernel_size"],
            embedding_size=embedding_size,
            attention_hidden=attention_hidden_size,
            simple_pool=simple_pool,
        ) / 1e6
        dist = abs(target - params_m)
        if dist < best_dist:
            best, best_dist = n, dist
    return best
