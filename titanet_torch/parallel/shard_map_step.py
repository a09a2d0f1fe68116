"""The explicit per-rank data-parallel step (port of
``titanet_tpu/parallel/shard_map_step.py``).

The default data-parallel path is ``train_step(..., mesh=mesh)``: the step
of one process fed the concatenated global batch (global-batch BatchNorm,
global random draws). This module is the JAX package's ``shard_map``
variant, with its collectives placed by hand:

- BatchNorm averages the ranks' moments with equal weight (the ``axis_name``
  rule of ``titanet_torch.ops.norm``: build the model with
  ``axis_name=axis_name``);
- dropout and SpecAugment draw from per-rank generators, the step's seed
  folded with the rank (``jax.random.fold_in(key, shard)``);
- the gradients and the loss are averaged over the ranks (``lax.pmean``),
  the gradients in one bucketed all-reduce.

On the card the step runs as one CUDA graph a step shape, collectives
included on an NCCL group (``jax.jit(shard_fn, donate_argnums=(0,))``);
see :func:`make_shard_map_train_step`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from titanet_torch.losses.heads import renormalize_params
from titanet_torch.ops.augment import spec_augment
from titanet_torch.ops.conv import dw_bwd_mode
from titanet_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from titanet_torch.ops.norm import ema_update_batch_stats
from titanet_torch.parallel.mesh import Mesh, replicated
from titanet_torch.train import state as _state
from titanet_torch.train.state import (
    TrainState,
    _dequantize_waveform,
    device_scalars,
    mean_over_ranks,
    wanted_under_mesh,
)


def _rank_seed(state: TrainState, mesh: Mesh, stream: int) -> int:
    """The seed of this rank's generator ``stream`` at the state's step: the
    state's dropout seed, the step, ``stream`` and the rank, mixed
    (``fold_in`` of the split key)."""
    seed = np.random.SeedSequence([state.generator.initial_seed(), state.step, stream, mesh.rank])
    return int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_shard_map_train_step(
    mesh: Mesh,
    *,
    model,
    head,
    optimizer,
    frontend: FrontendConfig,
    augment: Optional[tuple] = None,
    renorm_head: bool = False,
    axis_name: str = "data",
    capture: Optional[bool] = None,
):
    """The per-rank step ``step(state, waveform, lengths, speakers) ->
    (state, {"loss", "preds"})`` on this rank's rows; ``state`` is
    updated in place and holds ``model`` and ``head``. ``model`` must be
    built with ``axis_name=axis_name`` so that BatchNorm averages its batch
    moments over the ranks. ``augment``: SpecAugment masking
    ``(freq_ratio, freq_n, time_ratio, time_n, prob)`` on the mel.

    ``capture`` (:func:`titanet_torch.train.state.wanted_under_mesh`), as
    the JAX step is jitted with the state donated: None runs the step as
    one CUDA graph a step shape on the card (with every collective inside
    on an NCCL group; eagerly on a gloo group and on the CPU), False
    eagerly, True raises where a graph cannot hold the step. The graph
    holds the frontend, SpecAugment, the forward and backward, the mean of
    the gradients and of the loss over the ranks, the running statistics'
    update and the optimizer's device side; the host keeps the step count
    and the optimizer's counters and hands the step its scalars as one
    tensor (``Optimizer.applies`` / ``scalars`` / ``apply`` / ``advance``).
    The draws come from one generator a stream kept by the step, reseeded
    on the host before each call with the seed a fresh generator of that
    step and rank would take; the graph reads a registered generator's
    seed and offset at each replay, so its draws are the fresh generator's."""
    if mesh.axis_name != axis_name:
        raise ValueError(f"mesh axis {mesh.axis_name!r} is not {axis_name!r}")
    gens: dict = {}  # stream -> this rank's generator, made at the first call on the state's device

    def body(state, wav, lens, spk, scalars, applies, aug, drop):
        with mesh.active(global_batch=False), torch.no_grad():
            mel, mask = log_mel_spectrogram(_dequantize_waveform(wav), frontend, lengths=lens)
            if augment is not None:
                fr, fn, tr, tn, prob = augment
                mel = spec_augment(aug, mel, freq_mask_ratio=fr, freq_mask_num=fn, time_mask_ratio=tr,
                                   time_mask_num=tn, probability=prob, frames_mask=mask)
        model.train()
        head.train()
        with mesh.active(global_batch=False):
            emb = model(mel, generator=drop)
        _, preds, loss = head(emb, spk)
        params = state.params()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        loss = loss.detach()
        if mesh.size > 1:
            grads = mean_over_ranks(grads, mesh)
            loss = mean_over_ranks([loss], mesh, "loss")[0]
        # the batch moments were averaged over the ranks inside BatchNorm
        ema_update_batch_stats(model)
        updates = optimizer.apply(grads, state.opt_state, params, scalars, applies)
        with torch.no_grad():
            if updates is not None:
                torch._foreach_add_(params, updates)
            if renorm_head:
                renormalize_params(head)
        return {"loss": loss, "preds": preds}

    def step(state: TrainState, waveform, lengths, speakers):
        if state.model is not model or state.head is not head or state.optimizer is not optimizer:
            raise ValueError("the state must hold the step's model, head and optimizer")
        dev = mesh.device
        wav = torch.as_tensor(waveform, device=dev)
        lens = None if lengths is None else torch.as_tensor(lengths, device=dev)
        spk = torch.as_tensor(speakers, device=dev).long()
        for stream in (1, 2):
            if stream not in gens:
                gens[stream] = torch.Generator(device=state.generator.device)
            gens[stream].manual_seed(_rank_seed(state, mesh, stream))
        opt_state = state.opt_state
        applies = optimizer.applies(opt_state)
        scalars = device_scalars(optimizer.scalars(opt_state, dev), dev)
        fn = lambda w, ln, s, sc: body(state, w, ln, s, sc, applies, gens[1], gens[2])  # noqa: E731
        if wanted_under_mesh(capture, dev, mesh):
            static = (frontend, augment, renorm_head, applies, dw_bwd_mode(), mesh)
            metrics = _state.GRAPHS.run("shard_map_train_step", static, [state, optimizer, gens[1], gens[2]], fn,
                                        (wav, lens, spk, scalars))
        else:
            metrics = fn(wav, lens, spk, scalars)
        optimizer.advance(opt_state, applies)
        state.step += 1
        return state, metrics

    return step


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's parameters, buffers, optimizer state, weight EMA and step
    count on every rank (in place); returns ``state``."""
    if mesh.size == 1:
        return state
    rule = replicated(mesh)
    opt = state.opt_state
    tensors = (list(state.model.state_dict().values()) + list(state.head.state_dict().values())
               + [t for name in ("mu", "nu", "acc") for t in (getattr(opt, name) or [])]
               + list(state.ema or []))
    counts = torch.tensor([state.step, opt.count, opt.mini_step], dtype=torch.int64)
    with torch.no_grad():
        for t in tensors:
            t.copy_(rule.place(t))
        state.step, opt.count, opt.mini_step = (int(v) for v in rule.place(counts).tolist())
    return state
