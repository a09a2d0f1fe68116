"""Training, evaluation, verification and inference loops (port of
``titanet_tpu/train/loop.py``).

- per-epoch training with a data/model host-time split, metrics summed on
  the device and read once an epoch, console/JSONL/TensorBoard/W&B logging;
- validation every ``val_every`` epochs plus the first and the last;
- abort on a non-finite loss, probed every ``nan_check_every`` steps;
- checkpoints every ``checkpoints_frequency`` epochs and at the end, the
  best one (``track_best``) at ``0``, early stopping, resume;
- the final verification: every test utterance embedded once, whole
  (masked pooling), all pairs scored with one product.

Batches reach the device through :func:`titanet_torch.data.device_prefetch`
(pinned memory, a side stream) two steps ahead; a loader in device-resident
mode yields descriptors whose windows are gathered on the card
(:mod:`titanet_torch.data.device_corpus`). With ``figures_path`` each epoch
draws the train and validation embeddings
(:func:`titanet_torch.utils.viz.visualize_embeddings`) to disk, W&B and
TensorBoard.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from titanet_torch.data.loader import ChunkConfig, DataLoader, device_prefetch
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train.metrics import (
    all_pairs_scores_labels,
    get_test_metrics,
    metrics_from_class_counts,
)
from titanet_torch.train.state import (
    TrainState,
    accumulate_metrics,
    embed_step,
    ema_eval_state,
    eval_step,
    init_metrics_acc,
    train_step,
)
from titanet_torch.utils.logging import (
    ConsoleLogger,
    JsonlLogger,
    StepTimer,
    TensorBoardLogger,
    WandbLogger,
)


class NonFiniteLossError(RuntimeError):
    pass


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _staged_batches(loader, device, depth: int = 2):
    """Iterate a loader with each batch staged on ``device`` ``depth``
    batches ahead (:func:`device_prefetch`; a
    :class:`~titanet_torch.data.device_corpus.DeviceBatch` is gathered on
    the card, its waveform never crossing PCIe). Yields ((wav, lengths,
    speakers) device tensors, host Batch or DeviceBatch)."""
    for t, batch in device_prefetch(loader, device=device, size=depth):
        yield (t["waveform"], t["lengths"], t["speaker_ids"]), batch


def _host_metrics(acc, prefix: str) -> Dict[str, float]:
    """One read of a device accumulator: classification metrics (when the
    head predicts) and the summed and mean loss."""
    host = {k: v.cpu().numpy() for k, v in acc.__dict__.items()}
    metrics: Dict[str, float] = {}
    if int(host["n_examples"]) > 0:
        metrics = metrics_from_class_counts(
            host["tp"], host["pred_count"], host["true_count"],
            host["correct"], host["n_examples"], prefix=prefix,
        )
    steps = int(host["steps"])
    total_loss = float(host["loss_sum"]) if steps else float("nan")
    metrics[f"{prefix}/total_loss"] = total_loss
    metrics[f"{prefix}/avg_loss"] = total_loss / max(steps, 1)
    return metrics, bool(host["nonfinite"])


def train_one_epoch(
    epoch: int,
    total_epochs: int,
    state: TrainState,
    loader: DataLoader,
    *,
    frontend: FrontendConfig,
    augment=None,
    renorm_head: bool = False,
    ema_decay: Optional[float] = None,
    margin_warmup_steps: Optional[int] = None,
    teacher: Optional[tuple] = None,  # (teacher_model, alpha)
    console: Optional[ConsoleLogger] = None,
    collect_embeddings: bool = False,
    nan_check_every: int = 25,
):
    """One training epoch with metrics accumulated on the device: the host
    reads the accumulator's non-finite flag every ``nan_check_every`` steps
    and the accumulator once at the end. Per-step reads happen only in the
    interactive paths (console step logging, embedding collection).
    Returns ``(state, metrics, (embeddings or None, targets))``."""
    dev = _device_of(state)
    timer = StepTimer()
    all_targets, all_emb = [], []
    loader.set_epoch(epoch)
    step = 0
    n_steps = len(loader)
    acc = init_metrics_acc(state.head.n_classes, device=dev)
    sync_each_step = console is not None and console.enabled
    distill_kw = {}
    if teacher is not None:
        t_model, t_alpha = teacher
        distill_kw = dict(teacher_model=t_model, distill_alpha=t_alpha)
    timer.start("data")
    for (wav, lengths, speakers), batch in _staged_batches(loader, dev):
        timer.start("model")
        # Uniform-length fast path: a fully packed bucket needs no per-row
        # reflect-edge fixup or frame mask (the JAX loop's rule).
        uniform = int(batch.lengths.min()) == wav.shape[1]
        state, metrics = train_step(
            state, wav, None if uniform else lengths, speakers,
            frontend=frontend, augment=augment, renorm_head=renorm_head,
            ema_decay=ema_decay, margin_warmup_steps=margin_warmup_steps, **distill_kw,
        )
        acc = accumulate_metrics(acc, metrics["loss"], metrics["preds"], speakers)
        step += 1
        if collect_embeddings:
            all_emb.append(metrics["embeddings"].float().cpu().numpy())
            all_targets.extend(batch.speaker_ids.tolist())
        if sync_each_step:
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise NonFiniteLossError(f"Loss is {loss} at epoch {epoch} step {step}")
            console.log_step("train", epoch, total_epochs, step, n_steps, loss,
                             {"model": timer.totals.get("model", 0.0) / step})
        elif nan_check_every and step % nan_check_every == 0 and bool(acc.nonfinite):
            raise NonFiniteLossError(f"Loss became non-finite by epoch {epoch} step {step}")
        timer.start("data")
    timer.stop()

    epoch_metrics, nonfinite = _host_metrics(acc, "train")
    if nonfinite:
        raise NonFiniteLossError(f"Loss became non-finite during epoch {epoch}")
    epoch_metrics.update(timer.epoch_metrics("train"))
    embeddings = np.concatenate(all_emb) if all_emb else None
    return state, epoch_metrics, (embeddings, all_targets)


def evaluate(
    epoch,
    total_epochs,
    state: TrainState,
    loader: DataLoader,
    *,
    frontend: FrontendConfig,
    console: Optional[ConsoleLogger] = None,
    collect_embeddings: bool = False,
    prefix: str = "val",
):
    """No-grad mirror of :func:`train_one_epoch` (reference evaluate,
    src/learn.py:313-406), with the same device-side accumulation."""
    dev = _device_of(state)
    timer = StepTimer()
    all_targets, all_emb = [], []
    loader.set_epoch(epoch if isinstance(epoch, int) else 0)
    acc = init_metrics_acc(state.head.n_classes, device=dev)
    timer.start("data")
    for (wav, lengths, speakers), batch in _staged_batches(loader, dev):
        timer.start("model")
        out = eval_step(state, wav, lengths, speakers, frontend=frontend)
        acc = accumulate_metrics(acc, out["loss"], out["preds"], speakers)
        if collect_embeddings:
            all_emb.append(out["embeddings"].float().cpu().numpy())
            all_targets.extend(batch.speaker_ids.tolist())
        timer.start("data")
    timer.stop()
    metrics, _ = _host_metrics(acc, prefix)
    metrics.update(timer.epoch_metrics(prefix))
    if console:
        console.log_epoch(prefix, epoch, total_epochs, metrics)
    embeddings = np.concatenate(all_emb) if all_emb else None
    return metrics, (embeddings, all_targets)


def _embed_whole_utterances(state: TrainState, loader: DataLoader, *, frontend: FrontendConfig):
    """Embed every utterance of a non-chunking loader with masked pooling,
    so a padded batched embedding equals the utterance's solo embedding."""
    if loader.chunk.enabled:
        raise ValueError(
            "whole-utterance embedding requires a non-chunking loader; "
            "build it with chunk disabled"
        )
    dev = _device_of(state)
    embeddings, speakers = [], []
    loader.set_epoch(0)
    for (wav, lengths, _), batch in _staged_batches(loader, dev):
        emb = embed_step(state.model, wav, lengths, frontend=frontend, masked=True, device=dev)
        embeddings.append(emb.float().cpu().numpy())
        speakers.extend(batch.speaker_ids.tolist())
    return np.concatenate(embeddings), speakers


def run_verification(
    state: TrainState,
    loader: DataLoader,
    *,
    frontend: FrontendConfig,
    mindcf_p_target: float = 0.01,
    mindcf_c_fa: float = 1.0,
    mindcf_c_miss: float = 1.0,
    console: Optional[ConsoleLogger] = None,
    cohort_loader: Optional[DataLoader] = None,
    cohort_topk: Optional[int] = None,
    calibrate: bool = False,
):
    """All-pairs verification EER/minDCF over whole utterances (reference
    test, src/learn.py:409-459). ``cohort_loader`` (train-split
    utterances) enables S-norm, ``cohort_topk`` AS-norm; ``calibrate`` fits
    a logistic LLR calibration on the cohort's own all-pairs trials and
    reports Cllr, min Cllr and actual DCF of the calibrated test scores."""
    embeddings, speakers = _embed_whole_utterances(state, loader, frontend=frontend)
    cohort_embeddings = cohort_speakers = None
    if cohort_loader is not None:
        cohort_embeddings, cohort_speakers = _embed_whole_utterances(
            state, cohort_loader, frontend=frontend
        )
    scores, labels = all_pairs_scores_labels(
        embeddings, speakers, cohort_embeddings=cohort_embeddings, cohort_topk=cohort_topk,
    )
    metrics = get_test_metrics(
        scores, labels, mindcf_p_target=mindcf_p_target, mindcf_c_fa=mindcf_c_fa,
        mindcf_c_miss=mindcf_c_miss, prefix="test",
    )
    if calibrate:
        if cohort_embeddings is None:
            raise ValueError("calibrate=True requires a cohort_loader (labeled dev trials to fit on)")
        from titanet_torch.train.calibration import LogisticCalibration, actual_dcf, cllr, min_cllr

        # dev trials: the cohort's own all-pairs scores, transformed as the
        # test scores are, so that the affine fit transfers
        dev_scores, dev_labels = all_pairs_scores_labels(
            cohort_embeddings, cohort_speakers,
            cohort_embeddings=cohort_embeddings if cohort_topk else None,
            cohort_topk=cohort_topk,
        )
        cal = LogisticCalibration.fit(dev_scores, dev_labels)
        llrs = cal(scores)
        metrics["test/cllr"] = cllr(llrs, labels)
        metrics["test/min_cllr"] = min_cllr(scores, labels)
        metrics["test/act_dcf"] = actual_dcf(
            llrs, labels, p_target=mindcf_p_target, c_fa=mindcf_c_fa, c_miss=mindcf_c_miss,
        )
        metrics["test/cal_a"], metrics["test/cal_b"] = cal.a, cal.b
    if console:
        console.log_epoch("test", None, None, metrics)
    return metrics


def training_loop(
    run_name: str,
    epochs: int,
    state: TrainState,
    train_loader: DataLoader,
    checkpoints_path: str,
    *,
    frontend: FrontendConfig,
    augment=None,
    renorm_head: bool = False,
    ema_decay: Optional[float] = None,  # weight EMA; eval/test use EMA weights
    margin_warmup_steps: Optional[int] = None,
    teacher: Optional[tuple] = None,  # (teacher_model, alpha)
    test_loader: Optional[DataLoader] = None,
    val_loader: Optional[DataLoader] = None,
    val_every: Optional[int] = None,
    figures_path: Optional[str] = None,
    reduction_method: str = "svd",
    checkpoints_frequency: Optional[int] = 25,
    resume: bool = False,
    track_best: str = "val/avg_loss",  # save checkpoint "0" whenever this improves
    early_stop_patience: Optional[int] = None,  # in validations, on track_best
    console: Optional[ConsoleLogger] = None,
    jsonl: Optional[JsonlLogger] = None,
    wandb: Optional[WandbLogger] = None,
    tb: Optional[TensorBoardLogger] = None,
    cohort_loader: Optional[DataLoader] = None,
    cohort_topk: Optional[int] = None,
    calibrate: bool = False,
    mindcf_p_target: float = 0.01,
    mindcf_c_fa: float = 1.0,
    mindcf_c_miss: float = 1.0,
) -> TrainState:
    """Full training loop (reference training_loop, src/learn.py:204-310)
    with resume. ``figures_path`` turns on the per-epoch embedding figures
    (``<figures_path>/<run_name>/epoch_<n>_{train,val}.png``, projected by
    ``reduction_method``)."""
    console = console or ConsoleLogger(enabled=False)
    jsonl = jsonl or JsonlLogger(None)
    wandb = wandb or WandbLogger(enabled=False)
    tb = tb or TensorBoardLogger(None)
    run_ckpt_path = os.path.join(checkpoints_path, run_name)
    figures_dir = os.path.join(figures_path, run_name) if figures_path else None
    if figures_dir:
        os.makedirs(figures_dir, exist_ok=True)

    def draw(embeddings, targets, split: str, epoch: int) -> None:
        if embeddings is None:
            return
        from titanet_torch.utils.viz import visualize_embeddings

        path = os.path.join(figures_dir, f"epoch_{epoch}_{split}.png")
        # visualize_embeddings returns None (and writes nothing) without matplotlib
        if visualize_embeddings(embeddings, targets, reduction_method=reduction_method, save=path):
            # the reference pushes each epoch's embedding figure into the
            # W&B run (src/learn.py:401-406)
            wandb.log_image(f"{split}/embeddings", path, step=epoch)
            tb.log_image(f"{split}/embeddings", path, step=epoch)

    start_epoch = 0
    if resume:
        restored, start_epoch = ckpt.restore_latest(run_ckpt_path, state)
        if restored is not None:
            state = restored
            print(f"[resumed from epoch {start_epoch}]")

    # On NonFiniteLossError the run aborts; recovery is resume=true from
    # the last periodic checkpoint.
    best_value = float("inf")
    vals_since_best = 0
    epoch = start_epoch
    for epoch in range(start_epoch + 1, epochs + 1):
        state, metrics, train_collected = train_one_epoch(
            epoch, epochs, state, train_loader,
            frontend=frontend, augment=augment, renorm_head=renorm_head, ema_decay=ema_decay,
            margin_warmup_steps=margin_warmup_steps, teacher=teacher, console=console,
            collect_embeddings=figures_dir is not None,
        )
        console.log_epoch("train", epoch, epochs, metrics)
        if figures_dir is not None:
            draw(*train_collected, "train", epoch)
        jsonl.log(metrics, step=epoch)
        wandb.log(metrics, step=epoch)
        tb.log(metrics, step=epoch)

        if checkpoints_frequency and epoch % checkpoints_frequency == 0:
            ckpt.save_checkpoint(run_ckpt_path, epoch, state)
            wandb.save(os.path.join(run_ckpt_path, str(epoch)))

        if val_loader is not None and val_every is not None and (
            epoch % val_every == 0 or epoch == 1 or epoch == epochs
        ):
            # with weight EMA on, validation scores the EMA weights
            val_metrics, val_collected = evaluate(
                epoch, epochs, ema_eval_state(state), val_loader, frontend=frontend,
                console=console, collect_embeddings=figures_dir is not None,
            )
            if figures_dir is not None:
                draw(*val_collected, "val", epoch)
            jsonl.log(val_metrics, step=epoch)
            wandb.log(val_metrics, step=epoch)
            tb.log(val_metrics, step=epoch)
            # best checkpoint at 0 (epochs are 1-based, so it never masks
            # restore_latest) and early stopping
            value = val_metrics.get(track_best)
            if value is not None:
                if value < best_value:
                    best_value = value
                    vals_since_best = 0
                    ckpt.save_checkpoint(run_ckpt_path, 0, state)
                else:
                    vals_since_best += 1
                if early_stop_patience is not None and vals_since_best >= early_stop_patience:
                    print(f"[early stop at epoch {epoch}: {track_best} has not "
                          f"improved in {vals_since_best} validations]")
                    break

    if epoch > start_epoch:  # at least one epoch ran
        ckpt.save_checkpoint(run_ckpt_path, epoch, state)

    if test_loader is not None:
        test_metrics = run_verification(
            ema_eval_state(state), test_loader, frontend=frontend,
            mindcf_p_target=mindcf_p_target, mindcf_c_fa=mindcf_c_fa,
            mindcf_c_miss=mindcf_c_miss, console=console,
            cohort_loader=cohort_loader, cohort_topk=cohort_topk, calibrate=calibrate,
        )
        jsonl.log(test_metrics, step=epochs)
        tb.log(test_metrics, step=epochs)
        wandb.set_notes(json.dumps(test_metrics, indent=2))
    return state


def infer(
    state: TrainState,
    dataset,
    utterance_indices,
    *,
    frontend: FrontendConfig,
    sample_rate: int = 16000,
    batch_size: int = 8,
):
    """Embed chosen utterances (reference infer, src/learn.py:462-493),
    batched: ``(embeddings [N, E] float32, speaker ids)``."""
    from titanet_torch.data.dataset import Subset

    loader = DataLoader(
        Subset(dataset, utterance_indices), batch_size=batch_size, shuffle=False,
        drop_last=False, chunk=ChunkConfig(enabled=False), sample_rate=sample_rate, prefetch=0,
    )
    dev = _device_of(state)
    out, speakers = [], []
    for batch in loader:
        emb = embed_step(state.model, batch.waveform, batch.lengths, frontend=frontend, device=dev)
        out.append(emb.float().cpu().numpy())
        speakers.extend(batch.speaker_ids.tolist())
    return np.concatenate(out), speakers
