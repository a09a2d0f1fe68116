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
the identity and BatchNorm uses its running statistics. ``axis_name``
(every BatchNorm of the model) selects the JAX ``shard_map`` statistics
rule under an active mesh (:mod:`titanet_torch.parallel`); without it a
mesh gives global-batch statistics.

When the model is bf16 and there is no mask, the epilog's BatchNorm apply
and relu are folded into the fused pooling kernel, in both modes (in
training from the batch statistics).

``remat=True`` rematerializes each mega-block in a training forward that
records gradients (the JAX package's ``nn.remat(MegaBlock)``): the block
runs under ``torch.utils.checkpoint`` and the backward recomputes what it
did not keep, by ``remat_policy`` (:data:`REMAT_POLICIES`, the
``jax.checkpoint_policies`` names): None or ``nothing_saveable`` keeps the
block's input only, ``dots_saveable`` (``checkpoint_dots``) also the
outputs of its matrix products (the pointwise convolutions and the SE
layers); ``everything_saveable`` keeps every output, so nothing is
recomputed and the block runs as without remat. The loss, the gradients,
the published batch moments and the dropout generator's state are those
of the plain model: the block's four dropout masks are drawn before the
checkpointed call and passed in, and the recompute neither publishes
batch moments nor issues a collective again
(:class:`~titanet_torch.ops.norm.RematPass`).
"""

from __future__ import annotations

import contextlib
import functools
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from titanet_torch._device import resolve_device
from titanet_torch.models import common
from titanet_torch.ops.conv import DepthwiseSeparableConv1d, SamePadConv1d
from titanet_torch.ops.dense import Dense
from titanet_torch.ops.kernels.pool import kernel_supports
from titanet_torch.ops.norm import BatchNorm, FastDropout, RematPass
from titanet_torch.ops.pooling import AttentiveStatsPooling, SimplePooling
from titanet_torch.ops.se import SqueezeExcitation
from titanet_torch.parallel.mesh import active_mesh

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
        axis_name: Optional[str] = None,
    ):
        super().__init__()
        conv_cls = DepthwiseSeparableConv1d if depthwise else SamePadConv1d
        self.conv = conv_cls(in_features, features, kernel_size, dtype=dtype)
        self.norm = BatchNorm(features, dtype=dtype, axis_name=axis_name)
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, mask=None, defer_apply: bool = False, generator=None, keep=None):
        """``mask`` reaches the BatchNorm statistics in training only. With
        ``defer_apply`` return ``(conv(x), a, c)``: the BatchNorm apply and
        the relu are left to the consumer as ``relu(a*h + c)``. ``keep``:
        the dropout mask, drawn ahead (:meth:`FastDropout.keep_mask`)."""
        x = self.conv(x)
        if defer_apply:
            if self.dropout.rate:
                raise ValueError("defer_apply needs a block without dropout")
            a, c = self.norm(x, mask=mask, return_scale_shift=True)
            return x, a, c
        return self.dropout(torch.relu(self.norm(x, mask=mask)), generator, keep)


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
        axis_name: Optional[str] = None,
    ):
        super().__init__()
        self.n_sub_blocks = n_sub_blocks
        for i in range(n_sub_blocks):
            self.add_module(
                f"sub_block_{i}",
                ConvBlock1d(features, features, kernel_size, depthwise=True,
                            dropout=dropout, dtype=dtype, axis_name=axis_name),
            )
        self.se = SqueezeExcitation(features, se_reduction, dtype=dtype)
        self.skip_conv = SamePadConv1d(features, features, 1, dtype=dtype)
        self.skip_norm = BatchNorm(features, dtype=dtype, axis_name=axis_name)
        self.dropout = FastDropout(dropout)

    def dropouts(self) -> list:
        """The block's dropout sites in the order they draw: each
        sub-block's, then the block's own."""
        return [getattr(self, f"sub_block_{i}").dropout for i in range(self.n_sub_blocks)] + [self.dropout]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, generator=None,
                keeps=None) -> torch.Tensor:
        """``keeps``: the masks of :meth:`dropouts`, drawn ahead (a
        rematerialized block); None draws them here from ``generator``."""
        keeps = keeps or (None,) * (self.n_sub_blocks + 1)
        y = x
        for i in range(self.n_sub_blocks):
            y = getattr(self, f"sub_block_{i}")(y, mask=mask, generator=generator, keep=keeps[i])
        y = self.se(y, mask=mask)
        skip = self.skip_norm(self.skip_conv(x), mask=mask)
        return self.dropout(torch.relu(skip + y), generator, keeps[-1])


# remat_policy names (jax.checkpoint_policies); None is nothing_saveable
REMAT_POLICIES = ("nothing_saveable", "dots_saveable", "checkpoint_dots", "everything_saveable")
# the products a "dots" policy keeps (jax's dot_general): the pointwise
# convolutions and the SE layers run as F.linear, which dispatches these
_DOTS = frozenset((torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm))


def check_remat_policy(policy: Optional[str]) -> None:
    if policy is not None and policy not in REMAT_POLICIES:
        raise ValueError(f"unsupported remat_policy {policy!r}: one of None, {', '.join(REMAT_POLICIES)}")


def _keep_dots(ctx, op, *args, **kwargs):
    # only products the forward records for autograd: the recompute skips
    # what the forward computes without grad (the published moments)
    if torch.is_grad_enabled() and op.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def rematerialized(block: MegaBlock, x: torch.Tensor, mask, generator, policy: Optional[str]) -> torch.Tensor:
    """``block(x, mask=mask, generator=generator)`` under
    ``torch.utils.checkpoint`` with ``policy`` (module docstring). The
    dropout masks are drawn here, in the block's order, so the generator
    advances once, as the plain block advances it. The recompute runs
    under the mesh the forward ran under (the backward runs outside the
    step's ``mesh.active()``), with every BatchNorm of the block told it
    is the recompute."""
    keeps = tuple(d.keep_mask(x, generator) for d in block.dropouts())
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    passes = RematPass()
    mesh, global_batch = active_mesh()

    def run(x, mask, keeps):
        with mesh.active(global_batch) if passes.replay and mesh is not None else contextlib.nullcontext():
            for bn in norms:
                bn.remat = passes
            try:
                return block(x, mask=mask, keeps=keeps)
            finally:
                for bn in norms:
                    bn.remat = None
                passes.replay = True

    kw = {}
    if policy in ("dots_saveable", "checkpoint_dots"):
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _keep_dots)
    return checkpoint(run, x, mask, keeps, use_reentrant=False, preserve_rng_state=False, **kw)


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
        axis_name: Optional[str] = None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
    ):
        super().__init__()
        check_remat_policy(remat_policy)
        self.n_mega_blocks = n_mega_blocks
        self.remat, self.remat_policy = remat, remat_policy
        self.prolog = ConvBlock1d(n_mels, hidden_size, prolog_kernel_size, dtype=dtype, axis_name=axis_name)
        for i in range(n_mega_blocks):
            self.add_module(
                f"mega_block_{i}",
                MegaBlock(hidden_size, mega_block_kernel_size, n_sub_blocks, se_reduction,
                          dropout, dtype, axis_name),
            )
        self.epilog = ConvBlock1d(hidden_size, output_size, epilog_kernel_size, dtype=dtype,
                                  axis_name=axis_name)

    def forward(self, x, mask=None, defer_epilog: bool = False, generator=None):
        x = self.prolog(x, mask=mask)
        # everything_saveable keeps every output: nothing to recompute
        remat = (self.remat and self.remat_policy != "everything_saveable" and self.training
                 and torch.is_grad_enabled())
        for i in range(self.n_mega_blocks):
            block = getattr(self, f"mega_block_{i}")
            if remat:
                x = rematerialized(block, x, mask, generator, self.remat_policy)
            else:
                x = block(x, mask=mask, generator=generator)
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
        axis_name: Optional[str] = None,
    ):
        super().__init__()
        self.simple_pool = simple_pool
        if simple_pool:
            self.pool = SimplePooling(channels, dtype=dtype)
        else:
            self.pool = AttentiveStatsPooling(channels, attention_hidden_size, dtype=dtype)
            self.pool_norm = BatchNorm(2 * channels, dtype=dtype, axis_name=axis_name)
        self.linear = Dense(2 * channels, embedding_size, dtype=dtype)
        self.linear_norm = BatchNorm(embedding_size, dtype=dtype, axis_name=axis_name)

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
    :func:`titanet_torch.models.l2_normalize` for unit-norm embeddings.
    ``remat`` / ``remat_policy``: the mega-blocks' rematerialization
    (module docstring); an unknown policy raises ``ValueError``."""

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
        remat: bool = False,
        remat_policy: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        axis_name: Optional[str] = None,
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
            dropout, dtype, axis_name, remat, remat_policy,
        )
        self.decoder = Decoder(
            encoder_output_size, embedding_size, attention_hidden_size, simple_pool, dtype, axis_name
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
    axis_name: Optional[str] = None,
) -> TitaNet:
    """Size-preset constructor, in eval mode on ``device`` (``model.train()``
    selects the training forward). Weights are
    drawn from ``generator`` (default: a generator seeded with 0). If
    ``n_mega_blocks`` is None, picks the count whose parameter total is
    closest to the paper target. ``axis_name``: the BatchNorm rule of the
    ``shard_map`` step (:mod:`titanet_torch.parallel.shard_map_step`)."""
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
        axis_name=axis_name,
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


def _stack_leaves(trees):
    """Stack matching leaves of ``trees`` (nested dicts of arrays or
    tensors) along a new leading axis: ``torch.stack`` for tensors,
    ``np.stack`` for anything else."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return np.stack([np.asarray(t) for t in trees])


def _index_leaves(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _index_leaves(v, i) for k, v in tree.items()}
    return tree[i]


def stacked_size(tree) -> int:
    """The leading axis of a stacked tree's first leaf."""
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def stack_mega_block_params(collection: dict, n_mega_blocks: int) -> dict:
    """Convert one variable collection (params / batch_stats / ...) from the
    unrolled layout (``encoder/mega_block_{i}/...``) to the ``scan_blocks``
    layout (``encoder/mega_blocks/block/...`` with a leading ``[N]`` axis),
    as the JAX package's function of this name does; the inverse is
    :func:`unstack_mega_block_params`. Works on nested dicts of numpy
    arrays or tensors."""
    enc = dict(collection["encoder"])
    blocks = [enc.pop(f"mega_block_{i}") for i in range(n_mega_blocks)]
    enc["mega_blocks"] = {"block": _stack_leaves(blocks)}
    out = dict(collection)
    out["encoder"] = enc
    return out


def unstack_mega_block_params(collection: dict) -> dict:
    """Inverse of :func:`stack_mega_block_params`: the ``[N]`` axis of
    ``encoder/mega_blocks/block`` becomes ``encoder/mega_block_{i}``."""
    enc = dict(collection["encoder"])
    stacked = enc.pop("mega_blocks")["block"]
    for i in range(stacked_size(stacked)):
        enc[f"mega_block_{i}"] = _index_leaves(stacked, i)
    out = dict(collection)
    out["encoder"] = enc
    return out
