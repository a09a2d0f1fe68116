"""Train state, train/eval/inference steps and the optimizer (port of
``titanet_tpu/train/state.py``).

- :func:`embed_step`: wav -> unit-norm embeddings (serving);
  :func:`embed_step_quantized` is its int8 twin. On the card both, and
  :func:`eval_step`, run as one CUDA graph a shape
  (:mod:`titanet_torch.train.capture`) unless ``capture=False``.
- :func:`train_step`: in-step frontend (no grad) -> backbone in training
  mode (batch statistics, dropout from the state's generator) -> head ->
  loss -> gradients -> ONE running-statistics update over every BatchNorm
  site -> optimizer update -> optional angular-head renormalization and
  weight EMA. Optional masked statistics, margin warmup and distillation
  from a frozen teacher, as in the JAX step. ``augment`` (an
  :class:`~titanet_torch.ops.augment.AugmentConfig`) adds noise to the
  waveform and runs the SpecAugment frontend in the step, each from a
  generator of its own. On the card the whole step is one CUDA graph a
  shape (the JAX step is jitted with the state donated): the host keeps
  the counters and hands the step its scalars (learning rate, Adam's bias
  corrections, the accumulation divisor, the margin scale) as one f32
  tensor, and the graph advances the three generators as an eager step
  does. Under a mesh of P > 1 ranks on NCCL the graph holds the step's
  collectives too; on gloo the step runs eagerly.
- :func:`eval_step`, :class:`MetricsAcc` / :func:`accumulate_metrics`.
- :func:`make_optimizer`: Adam or SGD with optax's semantics (see
  :class:`Optimizer`).

Under a ``mesh`` (:mod:`titanet_torch.parallel`) of P > 1 ranks the steps
take this rank's rows of a global batch, the rank-ordered concatenation of
equal local batches, and compute what one process fed that batch computes:
BatchNorm over the global batch, every random draw over its shape, each
rank keeping its rows (so every rank draws P times its share), the loss as
its mean and the gradients averaged over the ranks in ONE bucketed
all-reduce before the gradient norm, so that clipping and the update are
the same on every rank. Every rank starts from the same weights and
generator seeds. At P = 1 the steps run exactly as without a mesh.

Unlike the JAX package the state is mutable: the step updates the model,
head and optimizer state in place and returns the same state object.
"""

from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch
from torch import nn

from titanet_torch._device import resolve_device
from titanet_torch.losses.heads import renormalize_params
from titanet_torch.models import l2_normalize
from titanet_torch.ops.augment import AugmentConfig, add_noise, log_mel_specaugment
from titanet_torch.ops.conv import dw_bwd_mode
from titanet_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from titanet_torch.ops.norm import ema_update_batch_stats
from titanet_torch.parallel import distributed as pd
from titanet_torch.train.capture import GRAPHS, wanted
from titanet_torch.utils.profiling import span


def _dequantize_waveform(waveform: torch.Tensor) -> torch.Tensor:
    """int16 PCM wire format -> float32; float inputs pass through."""
    if not waveform.is_floating_point():
        return waveform.to(torch.float32) * (1.0 / 32768.0)
    return waveform


def _upload_counts(*inputs) -> dict:
    """What an embedding step's inputs bring from the host: ``bytes`` of
    the host arrays and tensors among them, ``pinned`` whether every host
    tensor is in pinned memory (an array never is)."""
    host = [x for x in inputs if not (isinstance(x, torch.Tensor) and x.device.type != "cpu")]
    return {"bytes": int(sum(x.nbytes for x in host)),
            "pinned": all(isinstance(x, torch.Tensor) and x.is_pinned() for x in host)}


def _upload(x, dev: torch.device) -> torch.Tensor:
    """A step's input on ``dev``: a tensor in pinned host memory is copied
    without a wait for the device (the caller keeps it unchanged until the
    step's work has run); anything else as ``torch.as_tensor`` copies it."""
    if isinstance(x, torch.Tensor) and dev.type == "cuda" and x.device.type == "cpu" and x.is_pinned():
        return x.to(dev, non_blocking=True)
    return torch.as_tensor(x, device=dev)


def embed_step(
    model: torch.nn.Module,
    waveform,
    lengths,
    *,
    frontend: FrontendConfig,
    masked: bool = False,
    device="cuda",
    capture: Optional[bool] = None,
) -> torch.Tensor:
    """``waveform [B, T]`` (float or int16 PCM; tensor or array) and
    ``lengths [B]`` -> unit-norm embeddings ``[B, E]`` on ``device``, in the
    model's dtype. With ``masked``, SE and pooling ignore padded frames, so
    a padded row's embedding equals the utterance's solo embedding. Inputs
    in pinned host memory are uploaded without a wait for the card
    (:func:`_upload`): the caller leaves them unchanged until the step's
    work has run.

    ``capture`` (:func:`titanet_torch.train.capture.wanted`): None runs the
    step as a CUDA graph on the card, one a shape
    (:mod:`titanet_torch.train.capture`, as the JAX step is jitted), and
    eagerly on the CPU; False runs it eagerly; True on the CPU raises."""
    with span("embed.step"):
        dev = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != dev.type:
            raise ValueError(f"model is on {param.device}, embed_step was asked for {dev}")
        with span("embed.upload") as sp:
            if sp:
                sp.count(**_upload_counts(waveform, lengths))
            wav, lens = _upload(waveform, dev), _upload(lengths, dev)
        model.eval()

        def step(wav, lens):
            mel, mask = log_mel_spectrogram(_dequantize_waveform(wav), frontend, lengths=lens)
            return l2_normalize(model(mel, mask=mask if masked else None))

        with torch.inference_mode():
            if not wanted(capture, dev):
                return step(wav, lens)
            return GRAPHS.run("embed_step", (frontend, masked), (model,), step, (wav, lens))


def embed_step_quantized(
    qtree,
    waveform,
    lengths,
    *,
    frontend: FrontendConfig,
    masked: bool = False,
    device="cuda",
    capture: Optional[bool] = None,
) -> torch.Tensor:
    """Int8 serving twin of :func:`embed_step`: ``qtree`` is the tree
    :func:`titanet_torch.models.quantized.quantize_titanet` builds; wav ->
    unit-norm embeddings ``[B, E]`` (f32) on ``device``; ``capture`` as
    :func:`embed_step`'s."""
    from titanet_torch.models.quantized import titanet_apply_quantized

    with span("embed.step"):
        dev = resolve_device(device)
        if qtree.prolog_kernel.device.type != dev.type:
            raise ValueError(
                f"quantized tree is on {qtree.prolog_kernel.device}, embed_step_quantized was asked for {dev}"
            )
        with span("embed.upload") as sp:
            if sp:
                sp.count(**_upload_counts(waveform, lengths))
            wav, lens = _upload(waveform, dev), _upload(lengths, dev)

        def step(wav, lens):
            mel, mask = log_mel_spectrogram(_dequantize_waveform(wav), frontend, lengths=lens)
            return l2_normalize(titanet_apply_quantized(qtree, mel, mask=mask if masked else None))

        with torch.inference_mode():
            if not wanted(capture, dev):
                return step(wav, lens)
            return GRAPHS.run("embed_step_quantized", (frontend, masked), (qtree,), step, (wav, lens))


def _as_augment_config(augment) -> Optional[AugmentConfig]:
    """Normalize the ``augment`` argument: an AugmentConfig, or the legacy
    5-tuple (freq_ratio, freq_n, time_ratio, time_n, prob), which is masking
    and time stretch at the reference's 0.95-1.05 rates."""
    if augment is None or isinstance(augment, AugmentConfig):
        return augment
    fr, fn, tr, tn, prob = augment
    return AugmentConfig(
        freq_mask_ratio=fr, freq_mask_num=fn,
        time_mask_ratio=tr, time_mask_num=tn, probability=prob,
    )


# --------------------------------------------------------------- optimizer


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: read at the pre-increment count."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclass
class OptState:
    count: int = 0  # updates applied (optax's inner counts)
    mini_step: int = 0  # micro-batches accumulated (MultiSteps)
    mu: Optional[List[torch.Tensor]] = None
    nu: Optional[List[torch.Tensor]] = None
    acc: Optional[List[torch.Tensor]] = None


ADAM_B1, ADAM_B2 = 0.9, 0.999


def device_scalars(values: List[float], device) -> torch.Tensor:
    """Host floats (f64) -> one f32 tensor on ``device``: on the card
    through pinned memory without a wait for the device (an f32 cast of a
    double rounds as a ``_foreach`` op's scalar argument is rounded)."""
    host = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


class Optimizer:
    """optax's ``chain(clip_by_global_norm?, add_decayed_weights?,
    adam | sgd)``, optionally inside ``MultiSteps``, on lists of tensors:

    - clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
      (no ``+1e-6``, unlike ``clip_grad_norm_``);
    - weight decay adds ``wd * param`` to the gradient before Adam (L2, the
      same as torch Adam's ``weight_decay``);
    - Adam (b1 0.9, b2 0.999, eps 1e-8, optax's defaults):
      ``mu_hat / (sqrt(nu_hat) + eps)`` with bias corrections at the
      incremented count; the learning-rate schedule is read at the count
      before the increment;
    - ``accumulate_steps`` k > 1: gradients are averaged over k
      micro-batches (running mean) and the update and the schedule advance
      on every k-th call only.

    An update has a host side and a device side, so that a captured step
    holds the device side and reads no host value: :meth:`applies` and
    :meth:`scalars` (the step's learning rate, bias corrections and
    accumulation divisor, in f64) before the step, :meth:`apply` on the
    device with those scalars as a tensor, :meth:`advance` of the counters
    after. :meth:`update` runs the three.
    """

    def __init__(
        self,
        name: str,
        learning_rate: Union[float, Callable[[int], float]],
        weight_decay: float = 0.0,
        grad_clip_norm: Optional[float] = None,
        accumulate_steps: int = 1,
    ):
        if name not in ("adam", "sgd"):
            raise ValueError(f"Unknown optimizer {name!r}")
        self.name, self.learning_rate = name, learning_rate
        self.weight_decay, self.grad_clip_norm = weight_decay, grad_clip_norm
        self.accumulate_steps = accumulate_steps

    def lr(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    def init(self, params: List[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]  # noqa: E731
        state = OptState()
        if self.name == "adam":
            state.mu, state.nu = zeros(), zeros()
        if self.accumulate_steps > 1:
            state.acc = zeros()
        return state

    def applies(self, state: OptState) -> bool:
        """Whether the next call updates: every call, or under accumulation
        the one that completes k micro-batches."""
        return self.accumulate_steps <= 1 or (state.mini_step + 1) % self.accumulate_steps == 0

    def scalars(self, state: OptState, device) -> List[float]:
        """The next call's host values (f64) for a step on ``device``:
        ``-lr`` at the count, Adam's bias corrections ``1 - b1**t``, ``1 -
        b2**t`` at ``t = count + 1`` and the running mean's divisor
        ``mini_step + 1``. On the card the three divisors go as their
        reciprocals, which :meth:`apply` multiplies by: torch's CUDA
        ``_foreach_div`` by a Python scalar multiplies by its f64
        reciprocal, its CPU one divides, and the update keeps the bits it
        had with Python scalars on either device."""
        t = state.count + 1
        divisors = [1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t, float(state.mini_step + 1)]
        if torch.device(device).type == "cuda":
            divisors = [1.0 / d for d in divisors]
        return [-self.lr(state.count), *divisors]

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor], state: OptState, params: List[torch.Tensor],
              scalars: torch.Tensor, applies: bool):
        """The device side of an update: the updates to add to ``params``
        (new tensors), or None where ``applies`` is False and the call only
        accumulates. ``scalars``: :meth:`scalars` as a tensor on its
        device. Reads no host value and rebinds no state tensor (the
        accumulator is zeroed in place), so a CUDA graph can hold it."""
        neg_lr, bias1, bias2, acc_div = scalars[0], scalars[1], scalars[2], scalars[3]
        # a division by a step scalar: by its reciprocal on the card (:meth:`scalars`)
        div, div_ = ((torch._foreach_mul, torch._foreach_mul_) if scalars.is_cuda
                     else (torch._foreach_div, torch._foreach_div_))
        if self.accumulate_steps > 1:
            # optax MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, state.acc)
            div_(delta, acc_div)
            torch._foreach_add_(state.acc, delta)
            if not applies:
                return None
            grads = state.acc
        updates = list(grads)
        if self.grad_clip_norm:
            # a select on the device: without a clip, u / 1 * 1 is u to the bit
            norm = global_norm(updates)
            over = norm >= self.grad_clip_norm
            updates = torch._foreach_div(updates, torch.where(over, norm, 1.0))
            torch._foreach_mul_(updates, torch.where(over, self.grad_clip_norm, 1.0))
        if self.weight_decay:
            updates = torch._foreach_add(updates, params, alpha=self.weight_decay)
        if self.name == "adam":
            torch._foreach_mul_(state.mu, ADAM_B1)
            torch._foreach_add_(state.mu, updates, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(state.nu, ADAM_B2)
            torch._foreach_addcmul_(state.nu, updates, updates, value=1.0 - ADAM_B2)
            mu_hat = div(state.mu, bias1)
            nu_hat = div(state.nu, bias2)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, 1e-8)
            updates = torch._foreach_div(mu_hat, denom)
        else:
            updates = [u.clone() for u in updates]
        torch._foreach_mul_(updates, neg_lr)
        if self.accumulate_steps > 1:
            torch._foreach_zero_(state.acc)
        return updates

    def advance(self, state: OptState, applies: bool) -> None:
        """The host counters after a call: ``mini_step`` under
        accumulation, ``count`` where the call updated."""
        if self.accumulate_steps > 1:
            state.mini_step = (state.mini_step + 1) % self.accumulate_steps
        if applies:
            state.count += 1

    def update(self, grads: List[torch.Tensor], state: OptState, params: List[torch.Tensor]):
        """The updates to add to ``params`` (new tensors), or None on a
        micro-batch that only accumulates. Advances ``state`` in place."""
        applies = self.applies(state)
        dev = grads[0].device
        updates = self.apply(grads, state, params, device_scalars(self.scalars(state, dev), dev), applies)
        self.advance(state, applies)
        return updates


def make_optimizer(
    name: str = "adam",
    start_lr: float = 1e-3,
    weight_decay: float = 0.0,
    scheduler: bool = False,
    end_lr: float = 1e-5,
    total_epochs: int = 250,
    steps_per_epoch: int = 1,
    warmup_epochs: int = 0,
    grad_clip_norm: Optional[float] = None,
    accumulate_steps: int = 1,
) -> Optimizer:
    """Adam/SGD with an optional per-step cosine decay from ``start_lr`` to
    ``end_lr`` over ``total_epochs * steps_per_epoch`` steps, an optional
    linear warmup from 0 over ``warmup_epochs`` epochs (the cosine then
    starts after it), global-norm clipping, L2 weight decay and gradient
    accumulation over ``accumulate_steps`` micro-batches, as the JAX
    package's ``make_optimizer`` builds them with optax."""
    if scheduler:
        lr: Union[float, Callable[[int], float]] = cosine_decay_schedule(
            start_lr, max(total_epochs * steps_per_epoch, 1), end_lr / start_lr
        )
    else:
        lr = start_lr
    if warmup_epochs > 0:
        # optax.join_schedules of a linear 0 -> start_lr ramp over n steps
        # and the schedule above, which then sees count - n
        n, after = warmup_epochs * steps_per_epoch, lr

        def lr(count: int) -> float:
            if count < n:
                return -start_lr * (1.0 - count / n) + start_lr
            return after(count - n) if callable(after) else after
    return Optimizer(name, lr, weight_decay, grad_clip_norm, accumulate_steps)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


# ------------------------------------------------------------------- state


@dataclass
class TrainState:
    """Everything a train step reads and advances: the backbone, the head,
    the optimizer and its state, the step count, the dropout generator, the
    SpecAugment and noise generators and the optional weight-EMA copies
    (one per parameter of :meth:`params`).

    The three generators are apart, as the JAX step's keys are: the dropout
    draws do not depend on whether augmentation is on, and the SpecAugment
    draws not on whether noise is on."""

    model: nn.Module
    head: nn.Module
    optimizer: Optimizer
    opt_state: OptState
    generator: torch.Generator
    aug_generator: torch.Generator
    noise_generator: torch.Generator
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None

    def generators(self) -> dict:
        return {"dropout": self.generator, "specaugment": self.aug_generator,
                "noise": self.noise_generator}

    def params(self) -> List[torch.Tensor]:
        """Backbone then head parameters, in module order."""
        return list(self.model.parameters()) + list(self.head.parameters())


def create_train_state(
    model: nn.Module,
    head: nn.Module,
    optimizer: Optimizer,
    *,
    seed: int = 0,
    ema: bool = False,
) -> TrainState:
    """State for ``model`` and ``head`` (on one device, already initialized);
    the generators live on that device: dropout's is seeded with ``seed``,
    SpecAugment's and the noise's with seeds derived from it."""
    dev = next(model.parameters()).device
    if next(head.parameters()).device != dev:
        raise ValueError("model and head must be on one device")

    def stream(k):
        derived = int(np.random.SeedSequence([seed, k]).generate_state(1, np.uint64)[0])
        return torch.Generator(device=dev).manual_seed(derived)

    state = TrainState(
        model=model, head=head, optimizer=optimizer, opt_state=None,
        generator=torch.Generator(device=dev).manual_seed(seed),
        aug_generator=stream(1), noise_generator=stream(2),
    )
    params = state.params()
    state.opt_state = optimizer.init(params)
    if ema:
        state.ema = [p.detach().clone() for p in params]
    return state


def ema_eval_state(state: TrainState) -> TrainState:
    """A state whose model and head are copies holding the EMA weights
    (the state itself when EMA is off). The copy shares no tensor with
    ``state``."""
    if state.ema is None:
        return state
    model, head = copy.deepcopy(state.model), copy.deepcopy(state.head)
    with torch.no_grad():
        for p, e in zip(list(model.parameters()) + list(head.parameters()), state.ema):
            p.copy_(e)
    return TrainState(model=model, head=head, optimizer=state.optimizer,
                      opt_state=state.opt_state, generator=state.generator,
                      step=state.step, ema=state.ema, aug_generator=state.aug_generator,
                      noise_generator=state.noise_generator)


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def _mesh_active(mesh):
    return mesh.active() if _sharded(mesh) else contextlib.nullcontext()


def wanted_under_mesh(capture: Optional[bool], device: torch.device, mesh) -> bool:
    """Whether a train step on ``device`` under ``mesh`` runs as a CUDA
    graph: :func:`titanet_torch.train.capture.wanted`, and under a mesh of
    P > 1 ranks only on an NCCL group. A gloo group's collectives run on
    the host, which a graph cannot hold: there ``capture`` None runs
    eagerly and True raises."""
    if _sharded(mesh) and not pd.capturable(mesh.group):
        if capture:
            raise ValueError(f"a train step under a mesh of {mesh.size} ranks on a {pd.backend(mesh.group)} group "
                             "cannot be captured: gloo's collectives run on the host, outside any CUDA graph; "
                             "capture needs an NCCL group (capture=None runs such a step eagerly)")
        return False
    return wanted(capture, device)


def mean_over_ranks(tensors: List[torch.Tensor], mesh, kind: str = "gradients") -> List[torch.Tensor]:
    """The mean over the ranks of ``mesh`` of each tensor, in one all-reduce
    of a flat bucket a dtype (new tensors; counted under ``kind``)."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    with torch.no_grad():
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            flat = pd.all_reduce_(flat, mesh.group, kind=kind).div_(mesh.size)
            for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
                out[i] = part.view_as(tensors[i])
    return out


def _as_device_tensors(state: TrainState, waveform, lengths, speakers):
    """The step's inputs on the model's device (a step dequantizes int16
    PCM itself, inside its graph)."""
    dev = next(state.model.parameters()).device
    wav = torch.as_tensor(waveform, device=dev)
    lens = None if lengths is None else torch.as_tensor(lengths, device=dev)
    return wav, lens, torch.as_tensor(speakers, device=dev).long()


def margin_scale(step: int, margin_warmup_steps: Optional[int]) -> Optional[float]:
    """The angular margins' warm-up factor at ``step`` (None: no warm-up)."""
    if margin_warmup_steps is None or margin_warmup_steps <= 0:
        return None
    return min(max(step / float(margin_warmup_steps), 0.0), 1.0)


def loss_and_grads(
    state: TrainState,
    waveform,
    lengths,
    speakers,
    *,
    frontend: FrontendConfig,
    augment=None,
    masked: bool = False,
    margin=None,
    teacher_model: Optional[nn.Module] = None,
    distill_alpha: float = 0.5,
    mesh=None,
):
    """The forward and backward of :func:`train_step` without the update:
    ``(loss, grads, embeddings, preds)`` with one gradient per parameter of
    ``state.params()`` (None where the loss does not reach it). The
    BatchNorm sites publish their batch moments. Under a ``mesh`` of P > 1
    ranks: the global batch's loss and gradient mean (zeros, not None,
    where the loss does not reach a parameter), this rank's embeddings and
    predictions. ``margin``: the angular head's margin scale (a float, or
    a 0-dim tensor on the device as the captured step passes it; None: the
    plain margins)."""
    with _mesh_active(mesh):
        loss, emb, preds = _forward(
            state, waveform, lengths, speakers, frontend=frontend, augment=augment, masked=masked,
            margin=margin, teacher_model=teacher_model, distill_alpha=distill_alpha, mesh=mesh,
        )
    grads = list(torch.autograd.grad(loss, state.params(), allow_unused=True))
    loss = loss.detach()
    if _sharded(mesh):
        grads = mean_over_ranks([torch.zeros_like(p) if g is None else g
                                 for p, g in zip(state.params(), grads)], mesh)
        loss = mean_over_ranks([loss], mesh, "loss")[0]
    return loss, grads, emb, preds


def _forward(state, waveform, lengths, speakers, *, frontend, augment, masked, margin, teacher_model,
             distill_alpha, mesh):
    """Frontend, backbone and head of one training step: ``(loss of this
    rank's rows, its unit-norm embeddings (detached), its predictions)``.
    A head whose loss couples the rows (GE2E) sees the gathered global
    batch, and every rank then holds the global loss. ``margin``: the
    angular head's margin scale (None: the plain margins)."""
    wav, lens, spk = _as_device_tensors(state, waveform, lengths, speakers)
    wav = _dequantize_waveform(wav)
    aug = _as_augment_config(augment)
    with torch.no_grad():
        if aug is not None and aug.noise_prob > 0.0:
            wav = add_noise(
                state.noise_generator, wav, lens, probability=aug.noise_prob,
                snr_min=aug.noise_snr_min, snr_max=aug.noise_snr_max, color=aug.noise_color,
            )
        if aug is not None and aug.specaugment:
            # gated time stretch on the spectrogram + frequency/time masking,
            # mel in plain torch (the fused log-mel kernel has no stretch)
            mel, mask = log_mel_specaugment(state.aug_generator, wav, frontend, aug, lengths=lens)
        else:
            mel, mask = log_mel_spectrogram(wav, frontend, lengths=lens)
    model_mask = mask if masked else None
    state.model.train()
    state.head.train()
    emb = state.model(mel, mask=model_mask, generator=state.generator)
    head_kw = {} if margin is None else {"margin_scale": margin}
    rows = slice(None)
    if _sharded(mesh) and getattr(state.head, "couples_rows", False):
        rows = slice(mesh.rank * emb.shape[0], (mesh.rank + 1) * emb.shape[0])
        emb = pd.all_gather_rows(emb, mesh.rank, mesh.size, mesh.group, "head_rows")
        spk = pd.all_gather_rows(spk, mesh.rank, mesh.size, mesh.group, "head_rows")
    norm_emb, preds, loss = state.head(emb, spk, **head_kw)
    if rows != slice(None):
        # every rank computed the global loss; the gradient average over
        # the ranks then gives the global gradient
        norm_emb, preds = norm_emb[rows], None if preds is None else preds[rows]
    if teacher_model is not None:
        teacher_model.eval()
        with torch.no_grad():
            t_emb = l2_normalize(teacher_model(mel, mask=model_mask).float())
        distill = torch.mean(1.0 - torch.sum(norm_emb.float() * t_emb, dim=-1))
        loss = (1.0 - distill_alpha) * loss + distill_alpha * distill
    return loss, norm_emb.detach(), preds


def train_step(
    state: TrainState,
    waveform,
    lengths,
    speakers,
    *,
    frontend: FrontendConfig,
    augment=None,
    renorm_head: bool = False,
    masked: bool = False,
    ema_decay: Optional[float] = None,
    margin_warmup_steps: Optional[int] = None,
    teacher_model: Optional[nn.Module] = None,
    distill_alpha: float = 0.5,
    mesh=None,
    capture: Optional[bool] = None,
):
    """One wav -> gradients -> update step. ``waveform [B, T]`` (float or
    int16 PCM), ``lengths [B]`` or None (all rows full length), ``speakers
    [B]`` class ids, on the model's device or as arrays. Returns ``(state,
    metrics)`` with ``loss``, ``grad_norm`` (before clipping), ``preds``
    (None for GE2E) and the unit-norm ``embeddings``; ``state`` is updated
    in place. With ``teacher_model`` the loss is ``(1-alpha)*head_loss +
    alpha*(1 - cos(student, teacher))`` on the same mel. ``augment`` (an
    AugmentConfig or the legacy 5-tuple) adds noise first, from
    ``state.noise_generator``, then computes the mel with SpecAugment from
    ``state.aug_generator``. ``mesh``: the data-parallel step (module
    docstring); ``loss`` and ``grad_norm`` are then the global batch's,
    the same on every rank.

    ``capture`` (:func:`titanet_torch.train.capture.wanted`): None runs the
    step as one CUDA graph on the card and eagerly on the CPU; False runs
    it eagerly, the yardstick; True on the CPU raises. The graph holds the
    dequantize, noise and the frontend, the forward, the backward, the
    BatchNorm statistics' update, the optimizer update, the renorm and the
    weight EMA, and is keyed by the state (model, head, optimizer state,
    EMA), the optimizer, the teacher, the three generators (each advanced
    by every replay as an eager step advances it), the static arguments,
    whether this call updates or only accumulates, the depthwise-backward
    route and the inputs' shapes: one graph a bucket width, uniform or
    ragged. Under a ``mesh`` of P > 1 ranks on an NCCL group the graph also
    holds every collective of the step (BatchNorm's forward and backward
    all-reduces, the GE2E row gathers, the gradient bucket and the loss
    mean), and every rank captures on the same call
    (:mod:`titanet_torch.train.capture`); on a gloo group the step runs
    eagerly (None) or raises (True): :func:`wanted_under_mesh`."""
    with span("train.step", id=state.step):
        with span("train.prepare"):
            wav, lens, spk = _as_device_tensors(state, waveform, lengths, speakers)
            opt, opt_state = state.optimizer, state.opt_state
            applies = opt.applies(opt_state)
            margin = margin_scale(state.step, margin_warmup_steps)
            scalars = device_scalars(opt.scalars(opt_state, wav.device) + [margin or 0.0], wav.device)
        kw = dict(frontend=frontend, augment=_as_augment_config(augment), masked=masked,
                  teacher_model=teacher_model, distill_alpha=distill_alpha, mesh=mesh)

        def step(wav, lens, spk, scalars):
            loss, grads, emb, preds = loss_and_grads(
                state, wav, lens, spk, margin=None if margin is None else scalars[4], **kw)
            ema_update_batch_stats(state.model)
            params = state.params()
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            grad_norm = global_norm(grads)
            updates = opt.apply(grads, opt_state, params, scalars, applies)
            with torch.no_grad():
                if updates is not None:
                    torch._foreach_add_(params, updates)
                if renorm_head:
                    renormalize_params(state.head)
                if ema_decay is not None and state.ema is not None:
                    # weight EMA after the update and the renorm: e <- d*e + (1-d)*p
                    torch._foreach_mul_(state.ema, ema_decay)
                    torch._foreach_add_(state.ema, params, alpha=1.0 - ema_decay)
            return {"loss": loss, "grad_norm": grad_norm, "preds": preds, "embeddings": emb}

        if wanted_under_mesh(capture, wav.device, mesh):
            static = (kw["augment"], frontend, renorm_head, masked, ema_decay, margin is not None,
                      None if teacher_model is None else distill_alpha, applies, dw_bwd_mode(),
                      mesh if _sharded(mesh) else None)
            owners = ([state, opt] + ([] if teacher_model is None else [teacher_model])
                      + list(state.generators().values()))
            metrics = GRAPHS.run("train_step", static, owners, step, (wav, lens, spk, scalars))
        else:
            metrics = step(wav, lens, spk, scalars)
        opt.advance(opt_state, applies)
        state.step += 1
        return state, metrics


@torch.no_grad()
def eval_step(
    state: TrainState,
    waveform,
    lengths,
    speakers,
    *,
    frontend: FrontendConfig,
    masked: bool = False,
    mesh=None,
    capture: Optional[bool] = None,
):
    """No-grad mirror of :func:`train_step` in eval mode: ``{"loss",
    "preds", "embeddings"}``. Under a ``mesh`` of P > 1 ranks the rows are
    this rank's share of a global batch and ``loss`` is the global mean
    (the all-reduce runs after the step, outside its graph). ``capture`` as
    :func:`embed_step`'s: on the card the frontend, model and head run as
    one CUDA graph a shape."""
    wav, lens, spk = _as_device_tensors(state, waveform, lengths, speakers)
    state.model.eval()
    state.head.eval()

    def step(wav, lens, spk):
        mel, mask = log_mel_spectrogram(_dequantize_waveform(wav), frontend, lengths=lens)
        emb = state.model(mel, mask=mask if masked else None)
        norm_emb, preds, loss = state.head(emb, spk)
        return {"loss": loss, "preds": preds, "embeddings": norm_emb}

    if wanted(capture, wav.device):
        out = GRAPHS.run("eval_step", (frontend, masked), (state.model, state.head), step, (wav, lens, spk))
    else:
        out = step(wav, lens, spk)
    if _sharded(mesh):
        out["loss"] = mean_over_ranks([out["loss"]], mesh, "loss")[0]
    return out


# ----------------------------------------------------------------- metrics


@dataclass
class MetricsAcc:
    """Device-side epoch accumulator: summed loss, step count, whether any
    loss was non-finite, and classification counts per class."""

    loss_sum: torch.Tensor
    steps: torch.Tensor
    nonfinite: torch.Tensor
    correct: torch.Tensor
    n_examples: torch.Tensor
    tp: torch.Tensor
    pred_count: torch.Tensor
    true_count: torch.Tensor


def init_metrics_acc(n_classes: int, device="cuda") -> MetricsAcc:
    dev = resolve_device(device)
    scalar = lambda dt: torch.zeros((), dtype=dt, device=dev)  # noqa: E731
    per_class = lambda: torch.zeros(max(n_classes, 1), dtype=torch.int32, device=dev)  # noqa: E731
    return MetricsAcc(
        loss_sum=scalar(torch.float32), steps=scalar(torch.int32), nonfinite=scalar(torch.bool),
        correct=scalar(torch.int32), n_examples=scalar(torch.int32),
        tp=per_class(), pred_count=per_class(), true_count=per_class(),
    )


@torch.no_grad()
def accumulate_metrics(acc: MetricsAcc, loss, preds, targets) -> MetricsAcc:
    """Fold one step's (loss, preds, targets) into ``acc`` in place;
    returns ``acc``. ``preds`` None (GE2E) updates the loss terms only."""
    loss = torch.as_tensor(loss, device=acc.loss_sum.device).float()
    acc.loss_sum += loss
    acc.steps += 1
    acc.nonfinite |= ~torch.isfinite(loss)
    if preds is None:
        return acc
    # index_add_ keeps every count on the device: no host read (a masked
    # index or bincount on a CUDA tensor reads a size back)
    targets = torch.as_tensor(targets, device=acc.tp.device).long()
    preds = torch.as_tensor(preds, device=acc.tp.device).long()
    hit = (preds == targets).to(torch.int32)
    ones = torch.ones_like(hit)
    acc.correct += hit.sum().to(torch.int32)
    acc.n_examples += targets.shape[0]
    acc.tp.index_add_(0, targets, hit)
    acc.pred_count.index_add_(0, preds, ones)
    acc.true_count.index_add_(0, targets, ones)
    return acc
