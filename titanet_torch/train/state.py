"""Train state, train/eval/inference steps and the optimizer (port of
``titanet_tpu/train/state.py``).

- :func:`embed_step`: wav -> unit-norm embeddings (serving);
  :func:`embed_step_quantized` is its int8 twin.
- :func:`train_step`: in-step frontend (no grad) -> backbone in training
  mode (batch statistics, dropout from the state's generator) -> head ->
  loss -> gradients -> ONE running-statistics update over every BatchNorm
  site -> optimizer update -> optional angular-head renormalization and
  weight EMA. Optional masked statistics, margin warmup and distillation
  from a frozen teacher, as in the JAX step. ``augment`` (an
  :class:`~titanet_torch.ops.augment.AugmentConfig`) adds noise to the
  waveform and runs the SpecAugment frontend in the step, each from a
  generator of its own.
- :func:`eval_step`, :class:`MetricsAcc` / :func:`accumulate_metrics`.
- :func:`make_optimizer`: Adam or SGD with optax's semantics (see
  :class:`Optimizer`).

Unlike the JAX package the state is mutable: the step updates the model,
head and optimizer state in place and returns the same state object.
"""

from __future__ import annotations

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
from titanet_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from titanet_torch.ops.norm import ema_update_batch_stats


def _dequantize_waveform(waveform: torch.Tensor) -> torch.Tensor:
    """int16 PCM wire format -> float32; float inputs pass through."""
    if not waveform.is_floating_point():
        return waveform.to(torch.float32) * (1.0 / 32768.0)
    return waveform


def embed_step(
    model: torch.nn.Module,
    waveform,
    lengths,
    *,
    frontend: FrontendConfig,
    masked: bool = False,
    device="cuda",
) -> torch.Tensor:
    """``waveform [B, T]`` (float or int16 PCM; tensor or array) and
    ``lengths [B]`` -> unit-norm embeddings ``[B, E]`` on ``device``, in the
    model's dtype. With ``masked``, SE and pooling ignore padded frames, so
    a padded row's embedding equals the utterance's solo embedding."""
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, embed_step was asked for {dev}")
    wav = torch.as_tensor(waveform, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    model.eval()
    with torch.inference_mode():
        mel, mask = log_mel_spectrogram(_dequantize_waveform(wav), frontend, lengths=lens)
        emb = model(mel, mask=mask if masked else None)
        return l2_normalize(emb)


def embed_step_quantized(
    qtree,
    waveform,
    lengths,
    *,
    frontend: FrontendConfig,
    masked: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Int8 serving twin of :func:`embed_step`: ``qtree`` is the tree
    :func:`titanet_torch.models.quantized.quantize_titanet` builds; wav ->
    unit-norm embeddings ``[B, E]`` (f32) on ``device``."""
    from titanet_torch.models.quantized import titanet_apply_quantized

    dev = resolve_device(device)
    if qtree.prolog_kernel.device.type != dev.type:
        raise ValueError(
            f"quantized tree is on {qtree.prolog_kernel.device}, embed_step_quantized was asked for {dev}"
        )
    wav = torch.as_tensor(waveform, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    with torch.inference_mode():
        mel, mask = log_mel_spectrogram(_dequantize_waveform(wav), frontend, lengths=lens)
        emb = titanet_apply_quantized(qtree, mel, mask=mask if masked else None)
        return l2_normalize(emb)


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

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState, params: List[torch.Tensor]):
        """The updates to add to ``params`` (new tensors), or None on a
        micro-batch that only accumulates. Advances ``state`` in place."""
        if self.accumulate_steps > 1:
            n = state.mini_step
            # optax MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(state.acc, delta)
            state.mini_step = (n + 1) % self.accumulate_steps
            if state.mini_step != 0:
                return None
            grads, state.acc = state.acc, [torch.zeros_like(a) for a in state.acc]
        updates = list(grads)
        if self.grad_clip_norm:
            norm = global_norm(updates)
            if bool(norm >= self.grad_clip_norm):
                updates = torch._foreach_div(updates, norm)
                torch._foreach_mul_(updates, self.grad_clip_norm)
        if self.weight_decay:
            updates = torch._foreach_add(updates, params, alpha=self.weight_decay)
        lr = self.lr(state.count)
        if self.name == "adam":
            b1, b2 = 0.9, 0.999
            torch._foreach_mul_(state.mu, b1)
            torch._foreach_add_(state.mu, updates, alpha=1.0 - b1)
            torch._foreach_mul_(state.nu, b2)
            torch._foreach_addcmul_(state.nu, updates, updates, value=1.0 - b2)
            t = state.count + 1
            mu_hat = torch._foreach_div(state.mu, 1.0 - b1 ** t)
            nu_hat = torch._foreach_div(state.nu, 1.0 - b2 ** t)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, 1e-8)
            updates = torch._foreach_div(mu_hat, denom)
        else:
            updates = [u.clone() for u in updates]
        torch._foreach_mul_(updates, -lr)
        state.count += 1
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


def _as_device_tensors(state: TrainState, waveform, lengths, speakers):
    dev = next(state.model.parameters()).device
    wav = _dequantize_waveform(torch.as_tensor(waveform, device=dev))
    lens = None if lengths is None else torch.as_tensor(lengths, device=dev)
    return wav, lens, torch.as_tensor(speakers, device=dev).long()


def loss_and_grads(
    state: TrainState,
    waveform,
    lengths,
    speakers,
    *,
    frontend: FrontendConfig,
    augment=None,
    masked: bool = False,
    margin_warmup_steps: Optional[int] = None,
    teacher_model: Optional[nn.Module] = None,
    distill_alpha: float = 0.5,
):
    """The forward and backward of :func:`train_step` without the update:
    ``(loss, grads, embeddings, preds)`` with one gradient per parameter of
    ``state.params()`` (None where the loss does not reach it). The
    BatchNorm sites publish their batch moments."""
    wav, lens, spk = _as_device_tensors(state, waveform, lengths, speakers)
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
    head_kw = {}
    if margin_warmup_steps is not None and margin_warmup_steps > 0:
        head_kw["margin_scale"] = min(max(state.step / float(margin_warmup_steps), 0.0), 1.0)
    norm_emb, preds, loss = state.head(emb, spk, **head_kw)
    if teacher_model is not None:
        teacher_model.eval()
        with torch.no_grad():
            t_emb = l2_normalize(teacher_model(mel, mask=model_mask).float())
        distill = torch.mean(1.0 - torch.sum(norm_emb.float() * t_emb, dim=-1))
        loss = (1.0 - distill_alpha) * loss + distill_alpha * distill
    grads = torch.autograd.grad(loss, state.params(), allow_unused=True)
    return loss.detach(), list(grads), norm_emb.detach(), preds


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
    ``state.aug_generator``."""
    loss, grads, emb, preds = loss_and_grads(
        state, waveform, lengths, speakers, frontend=frontend, augment=augment, masked=masked,
        margin_warmup_steps=margin_warmup_steps, teacher_model=teacher_model,
        distill_alpha=distill_alpha,
    )
    ema_update_batch_stats(state.model)
    params = state.params()
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    grad_norm = global_norm(grads)
    updates = state.optimizer.update(grads, state.opt_state, params)
    with torch.no_grad():
        if updates is not None:
            torch._foreach_add_(params, updates)
        if renorm_head:
            renormalize_params(state.head)
        if ema_decay is not None and state.ema is not None:
            # weight EMA after the update and the renorm: e <- d*e + (1-d)*p
            torch._foreach_mul_(state.ema, ema_decay)
            torch._foreach_add_(state.ema, params, alpha=1.0 - ema_decay)
    state.step += 1
    metrics = {"loss": loss, "grad_norm": grad_norm, "preds": preds, "embeddings": emb}
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
):
    """No-grad mirror of :func:`train_step` in eval mode: ``{"loss",
    "preds", "embeddings"}``."""
    wav, lens, spk = _as_device_tensors(state, waveform, lengths, speakers)
    mel, mask = log_mel_spectrogram(wav, frontend, lengths=lens)
    state.model.eval()
    state.head.eval()
    emb = state.model(mel, mask=mask if masked else None)
    norm_emb, preds, loss = state.head(emb, spk)
    return {"loss": loss, "preds": preds, "embeddings": norm_emb}


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
