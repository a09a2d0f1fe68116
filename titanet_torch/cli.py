"""Command line of the port: ``python -m titanet_torch train -p params.yml``
and ``python -m titanet_torch eval -p params.yml -c <run dir>`` (port of
``titanet_tpu/cli.py``'s ``train`` and ``eval``).

The same YAML schema as the JAX package drives the model, the loss, the
data and the augmentation. Everything runs on the card (``--device cuda``,
the default) unless the caller names the CPU.

The frontend always takes the fused log-mel route, on either device: the
kernel on the card (at ``audio.frontend_precision: highest`` its f32 mode,
which agrees with plain torch to rounding), its plain version on the CPU.
So a CPU run computes what the card's kernel does, and
``audio.use_pallas_fused`` (the JAX package's switch for its TPU kernel) is
not read.

Not ported yet; these raise with the ROADMAP item that holds them:
``figures.enabled`` (Queue 1 item 8), ``generic.device_corpus`` (item 5),
``mesh.num_devices`` above 1 (item 6), a model family other than TitaNet
(item 7), corpus, RIR or noise ``download`` (item 3). The ``infer``,
``trials`` and ``diarize`` subcommands wait for their modules (items 3-4).
"""

from __future__ import annotations

import argparse
import datetime
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from titanet_torch._device import resolve_device
from titanet_torch.config import Config, apply_overrides, load_config
from titanet_torch.data import (
    ChunkConfig,
    DataLoader,
    NoiseMixConfig,
    ReverbConfig,
    SpeedConfig,
    Subset,
    get_datasets,
)
from titanet_torch.losses.heads import build_head
from titanet_torch.models import get_titanet
from titanet_torch.ops.augment import AugmentConfig
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train.loop import run_verification, training_loop
from titanet_torch.train.state import create_train_state, ema_eval_state, make_optimizer
from titanet_torch.utils import (
    ConsoleLogger,
    JsonlLogger,
    TensorBoardLogger,
    WandbLogger,
    chart_dependencies,
    set_seed,
)

_OTHER_FAMILIES = ("dumb", "baseline", "ecapa", "xvector", "resnet", "conformer")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to titanet_torch yet (ROADMAP Queue 1 item {item})")


def _dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.training.dtype == "bfloat16" else None


def build_model(cfg: Config, dtype=None, device="cuda", generator: Optional[torch.Generator] = None):
    """TitaNet S/M/L from ``cfg.titanet`` on ``device``, weights drawn from
    ``generator``. The JAX package's model selection puts the other
    families first when enabled (reference src/train.py:87-121); they are
    not ported and raise."""
    for family in _OTHER_FAMILIES:
        if getattr(cfg, family).enabled:
            raise _not_ported(f"the {family!r} model family", "7 (model zoo)")
    return get_titanet(
        embedding_size=cfg.generic.embedding_size,
        n_mels=cfg.audio.spectrogram.n_mels,
        n_mega_blocks=cfg.titanet.n_mega_blocks,
        model_size=cfg.titanet.model_size,
        attention_hidden_size=cfg.titanet.attention_hidden_size,
        simple_pool=cfg.titanet.simple_pool,
        dropout=cfg.titanet.dropout,
        dtype=dtype,
        device=device,
        generator=generator,
    )


def build_head_from_config(cfg: Config, n_speakers: int, device="cuda",
                           generator: Optional[torch.Generator] = None):
    loss_name = cfg.training.loss
    kwargs = {}
    if loss_name in ("sphere", "cos", "arc"):
        lc = getattr(cfg.loss, loss_name)
        kwargs = dict(margin=lc.margin, scale=lc.scale, sub_centers=lc.sub_centers)
    return build_head(loss_name, cfg.generic.embedding_size, n_speakers, device=device,
                      generator=generator, **kwargs)


def _margin_warmup_steps(cfg: Config, steps_per_epoch: int):
    """loss.<head>.margin_warmup_epochs -> optimizer steps (None = off)."""
    epochs = {
        "sphere": cfg.loss.sphere.margin_warmup_epochs,
        "cos": cfg.loss.cos.margin_warmup_epochs,
        "arc": cfg.loss.arc.margin_warmup_epochs,
    }.get(cfg.training.loss, 0)
    return epochs * steps_per_epoch if epochs > 0 else None


def _synthetic_kwargs(cfg: Config) -> dict:
    # "synthetic" alone or as a member of a "+"-union corpus name
    if "synthetic" not in cfg.dataset.name.split("+"):
        return {}
    return dict(
        n_speakers=cfg.dataset.synthetic_speakers,
        utterances_per_speaker=cfg.dataset.synthetic_utterances,
        seed=cfg.dataset.synthetic_seed,
        formant_jitter=cfg.dataset.synthetic_formant_jitter,
        noise_level=cfg.dataset.synthetic_noise,
        reverb_prob=cfg.dataset.synthetic_reverb_prob,
        pitch_jitter=cfg.dataset.synthetic_pitch_jitter,
        f0_range=(cfg.dataset.synthetic_f0_min, cfg.dataset.synthetic_f0_max),
    )


def _noise_mix_config(cfg: Config) -> Optional[NoiseMixConfig]:
    """``augmentation.noise.source: files`` -> host-side mixing of the
    recordings under ``corpora_path`` for the TRAIN loader; None otherwise
    (``source: synthetic`` is the device-side noise of the train step)."""
    no = cfg.augmentation.noise
    if "noise" not in (cfg.augmentation.enable or []) or no.source != "files":
        return None
    paths = tuple(str(p) for p in sorted(Path(no.corpora_path).rglob("*.wav")))
    if not paths and no.download:
        raise _not_ported("fetching MUSAN (augmentation.noise.download)", "3 (data/acquire.py)")
    if not paths:
        raise FileNotFoundError(
            f"augmentation.noise.source=files but no wavs under {no.corpora_path!r}"
        )
    return NoiseMixConfig(
        paths=paths, probability=cfg.augmentation.probability,
        snr_min=no.snr_min, snr_max=no.snr_max, enabled=True,
    )


def _cohort_loader(cfg: Config, train_ds):
    """Cohort loader for test-time S-norm/AS-norm and calibration
    (``test.score_norm``, ``test.calibration``): a seeded sample of
    TRAIN-split utterances. Returns ``(loader or None, topk or None)``."""
    mode = cfg.test.score_norm
    if mode in (None, "none") and not cfg.test.calibration:
        return None, None
    if mode in (None, "none"):
        mode = "none_cohort"  # calibration only: a cohort without snorm
    if mode not in ("snorm", "asnorm", "none_cohort"):
        raise ValueError(f"test.score_norm must be 'none', 'snorm' or 'asnorm', got {mode!r}")
    rng = np.random.default_rng(cfg.generic.seed)
    n = min(cfg.test.cohort_size, len(train_ds))
    indices = rng.choice(len(train_ds), size=n, replace=False).tolist()
    loader = DataLoader(
        Subset(train_ds, indices), batch_size=cfg.validation.batch_size,
        shuffle=False, drop_last=False, chunk=ChunkConfig(enabled=False),
        sample_rate=cfg.audio.sample_rate, seed=cfg.generic.seed,
    )
    topk = cfg.test.asnorm_topk if mode == "asnorm" else None
    return loader, topk


def _check_ported(cfg: Config) -> None:
    if cfg.figures.enabled:
        raise _not_ported("figures.enabled (embedding figures, utils/viz.py)", "8")
    if cfg.generic.device_corpus:
        raise _not_ported("generic.device_corpus (the device-resident corpus)", "5")
    if cfg.mesh.num_devices is not None and cfg.mesh.num_devices > 1:
        raise _not_ported("training on more than one device (mesh.num_devices > 1)", "6")


def _frontend(cfg: Config) -> FrontendConfig:
    return FrontendConfig.from_ms(
        sample_rate=cfg.audio.sample_rate,
        n_fft=cfg.audio.spectrogram.n_fft,
        win_ms=cfg.audio.spectrogram.win_length,
        hop_ms=cfg.audio.spectrogram.hop_length,
        n_mels=cfg.audio.spectrogram.n_mels,
        precision=cfg.audio.frontend_precision,
        use_pallas_fused=True,
    )


def _datasets(cfg: Config, test: bool):
    return get_datasets(
        cfg.dataset.root,
        name=cfg.dataset.name,
        val=cfg.validation.enabled,
        val_utterances_per_speaker=cfg.validation.num_utterances_per_speaker,
        test=test,
        test_speakers=cfg.test.num_speakers,
        test_utterances_per_speaker=cfg.test.num_utterances_per_speaker,
        exclusive_test_speakers=cfg.test.exclusive_speakers,
        **_synthetic_kwargs(cfg),
    )


def _augment_config(cfg: Config, noise_mix) -> Optional[AugmentConfig]:
    """The train step's in-step augmentation: SpecAugment (gated time
    stretch at speed.min..max + frequency/time masking) and device-side
    noise, or None."""
    enabled = cfg.augmentation.enable or []
    if "specaugment" not in enabled and "noise" not in enabled:
        return None
    sa, no = cfg.augmentation.specaugment, cfg.augmentation.noise
    return AugmentConfig(
        min_rate=cfg.augmentation.speed.min, max_rate=cfg.augmentation.speed.max,
        freq_mask_ratio=sa.freq_mask_ratio, freq_mask_num=sa.freq_mask_num,
        time_mask_ratio=sa.time_mask_ratio, time_mask_num=sa.time_mask_num,
        probability=cfg.augmentation.probability,
        specaugment="specaugment" in enabled,
        noise_prob=cfg.augmentation.probability if "noise" in enabled and noise_mix is None else 0.0,
        noise_snr_min=no.snr_min, noise_snr_max=no.snr_max, noise_color=no.color,
    )


def _optimizer(cfg: Config, steps_per_epoch: int = 1):
    o = cfg.training.optimizer
    return make_optimizer(
        name=o.type, start_lr=o.start_lr, weight_decay=o.weight_decay, scheduler=o.scheduler,
        end_lr=o.end_lr, total_epochs=cfg.training.epochs, steps_per_epoch=steps_per_epoch,
        warmup_epochs=o.warmup_epochs, grad_clip_norm=o.grad_clip_norm,
        accumulate_steps=o.accumulate_steps,
    )


def _new_state(cfg: Config, n_speakers: int, dev: torch.device, steps_per_epoch: int = 1):
    """(model, head, state) as training builds them: weights drawn from
    generators seeded with ``generic.seed``."""
    gen = torch.Generator().manual_seed(cfg.generic.seed)
    model = build_model(cfg, dtype=_dtype(cfg), device=dev, generator=gen)
    head = build_head_from_config(cfg, n_speakers, device=dev, generator=gen)
    state = create_train_state(
        model, head, _optimizer(cfg, steps_per_epoch), seed=cfg.generic.seed,
        ema=cfg.training.ema_decay > 0,
    )
    return model, head, state


def _load_teacher(cfg: Config, n_speakers: int, device="cuda"):
    """The frozen distillation teacher from ``cfg.distill``: ``(model,
    alpha)`` for the train step, or None. Its architecture is THIS config
    plus ``distill.teacher_overrides``; its weights come from the newest
    checkpoint of the run directory ``distill.teacher_checkpoint`` (the EMA
    weights when present and ``teacher_ema``)."""
    if not cfg.distill.enabled:
        return None
    if not cfg.distill.teacher_checkpoint:
        raise ValueError("distill.enabled requires distill.teacher_checkpoint")
    tcfg = (apply_overrides(cfg, dict(cfg.distill.teacher_overrides))
            if cfg.distill.teacher_overrides else cfg)
    model, _, _, state = _rebuild_state(tcfg, n_speakers, device=device)
    restored, _ = ckpt.restore_latest(cfg.distill.teacher_checkpoint, state)
    if restored is None:
        raise FileNotFoundError(f"no teacher checkpoint under {cfg.distill.teacher_checkpoint!r}")
    if cfg.distill.teacher_ema and restored.ema is not None:
        model = ema_eval_state(restored).model
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval(), cfg.distill.alpha


def _loaders(cfg: Config, train_ds, val_ds, test_ds, noise_mix):
    """The loaders :func:`train` runs: ``(train, validation, test)``, the
    last two None where ``cfg`` turns them off."""
    enabled = cfg.augmentation.enable or []
    chunk = ChunkConfig(
        max_length=cfg.augmentation.chunk.max_length,
        lengths=tuple(cfg.augmentation.chunk.lengths),
        enabled="chunk" in enabled,
    )
    speed = SpeedConfig(
        rates=(cfg.augmentation.speed.min, 1.0, cfg.augmentation.speed.max),
        probability=cfg.augmentation.probability,
        enabled="speed" in enabled,
        continuous=cfg.augmentation.speed.continuous,
    )
    rir_paths: tuple = ()
    if "reverb" in enabled:
        rir_root = cfg.augmentation.rir.corpora_path
        rir_paths = tuple(str(p) for p in sorted(Path(rir_root).rglob("*.wav")))
        if not rir_paths and cfg.augmentation.rir.download:
            raise _not_ported("fetching the RIR corpus (augmentation.rir.download)", "3 (data/acquire.py)")
    reverb = ReverbConfig(
        rir_paths=rir_paths, probability=cfg.augmentation.probability,
        enabled="reverb" in enabled and bool(rir_paths),
    )
    balanced = None
    if cfg.training.balanced_speakers and cfg.training.balanced_utterances:
        balanced = (cfg.training.balanced_speakers, cfg.training.balanced_utterances)
    cache_kw = dict(cache_waveforms=cfg.generic.cache_waveforms,
                    cache_budget_mb=cfg.generic.cache_budget_mb)
    train_loader = DataLoader(
        train_ds, batch_size=cfg.training.batch_size, shuffle=True,
        chunk=chunk, speed=speed, reverb=reverb, noise=noise_mix, balanced=balanced,
        sample_rate=cfg.audio.sample_rate, seed=cfg.generic.seed,
        num_workers=max(cfg.generic.workers, 0),
        transport_dtype=cfg.training.transport_dtype, **cache_kw,
    )
    val_loader = DataLoader(
        val_ds, batch_size=cfg.validation.batch_size, shuffle=False,
        chunk=ChunkConfig(enabled=False), sample_rate=cfg.audio.sample_rate,
        seed=cfg.generic.seed, **cache_kw,
    ) if cfg.validation.enabled else None
    test_loader = DataLoader(
        test_ds, batch_size=cfg.validation.batch_size, shuffle=False,
        drop_last=False, chunk=ChunkConfig(enabled=False),
        sample_rate=cfg.audio.sample_rate, seed=cfg.generic.seed, **cache_kw,
    ) if cfg.test.enabled else None
    return train_loader, val_loader, test_loader


def train(cfg: Config, device="cuda"):
    """Train as ``cfg`` says; returns the final train state. Checkpoints
    and ``metrics.jsonl`` go under ``training.checkpoints_path/<run>``."""
    dev = resolve_device(device)
    _check_ported(cfg)
    set_seed(cfg.generic.seed)
    frontend = _frontend(cfg)
    train_ds, val_ds, test_ds, n_speakers = _datasets(cfg, cfg.test.enabled)
    noise_mix = _noise_mix_config(cfg)
    train_loader, val_loader, test_loader = _loaders(cfg, train_ds, val_ds, test_ds, noise_mix)
    cohort_loader, cohort_topk = _cohort_loader(cfg, train_ds) if cfg.test.enabled else (None, None)

    model, head, state = _new_state(cfg, n_speakers, dev, max(len(train_loader), 1))
    if cfg.generic.chart_dependencies:
        chart_dependencies(model, n_mels=cfg.audio.spectrogram.n_mels)

    run_name = cfg.training.run_name
    if run_name is None and cfg.training.resume:
        # resume the most recent run under checkpoints_path
        base = cfg.training.checkpoints_path
        if os.path.isdir(base):
            runs = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
            run_name = runs[-1] if runs else None
    if run_name is None:
        run_name = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    console = ConsoleLogger(enabled=cfg.generic.log_console)
    jsonl = JsonlLogger(os.path.join(cfg.training.checkpoints_path, run_name, "metrics.jsonl"))
    wandb = WandbLogger(
        enabled=cfg.wandb.enabled, api_key_file=cfg.wandb.api_key_file,
        project=cfg.wandb.project, entity=cfg.wandb.entity or None,
        name=run_name, config=cfg.to_dict(),
    )
    tb = TensorBoardLogger(
        os.path.join(cfg.generic.tensorboard_dir, run_name) if cfg.generic.tensorboard_dir else None
    )
    try:
        state = training_loop(
            run_name, cfg.training.epochs, state, train_loader, cfg.training.checkpoints_path,
            frontend=frontend,
            augment=_augment_config(cfg, noise_mix),
            renorm_head=cfg.training.loss in ("sphere", "cos", "arc"),
            ema_decay=cfg.training.ema_decay or None,
            margin_warmup_steps=_margin_warmup_steps(cfg, len(train_loader)),
            teacher=_load_teacher(cfg, n_speakers, device=dev),
            test_loader=test_loader,
            val_loader=val_loader,
            val_every=cfg.validation.every if cfg.validation.enabled else None,
            checkpoints_frequency=cfg.training.checkpoints_frequency,
            resume=cfg.training.resume,
            track_best=cfg.training.track_best,
            early_stop_patience=cfg.training.early_stop_patience,
            console=console, jsonl=jsonl, wandb=wandb, tb=tb,
            cohort_loader=cohort_loader, cohort_topk=cohort_topk,
            calibrate=cfg.test.calibration,
            mindcf_p_target=cfg.test.mindcf_p_target,
            mindcf_c_fa=cfg.test.mindcf_c_fa,
            mindcf_c_miss=cfg.test.mindcf_c_miss,
        )
    finally:
        wandb.finish()
        tb.finish()
    return state


def _rebuild_state(cfg: Config, n_speakers: int, device="cuda"):
    """(model, head, frontend, state) shaped as training built them, to
    restore a checkpoint into."""
    dev = resolve_device(device)
    _check_ported(cfg)
    model, head, state = _new_state(cfg, n_speakers, dev)
    return model, head, _frontend(cfg), state


def evaluate_checkpoint(cfg: Config, checkpoint_dir: str, epoch: Optional[int] = None, device="cuda"):
    """Verification EER/minDCF of a saved checkpoint (the newest under
    ``checkpoint_dir`` unless ``epoch`` is given), with the EMA weights when
    the run kept them."""
    train_ds, _, test_ds, n_speakers = _datasets(cfg, True)
    _, _, frontend, state = _rebuild_state(cfg, n_speakers, device=device)
    if epoch is None:
        restored, epoch = ckpt.restore_latest(checkpoint_dir, state)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    else:
        ckpt.restore_checkpoint(checkpoint_dir, epoch, state)
    loader = DataLoader(
        test_ds, batch_size=cfg.validation.batch_size, shuffle=False,
        drop_last=False, chunk=ChunkConfig(enabled=False),
        sample_rate=cfg.audio.sample_rate, seed=cfg.generic.seed,
    )
    cohort_loader, cohort_topk = _cohort_loader(cfg, train_ds)
    metrics = run_verification(
        ema_eval_state(state), loader, frontend=frontend,
        mindcf_p_target=cfg.test.mindcf_p_target,
        mindcf_c_fa=cfg.test.mindcf_c_fa, mindcf_c_miss=cfg.test.mindcf_c_miss,
        console=ConsoleLogger(enabled=True),
        cohort_loader=cohort_loader, cohort_topk=cohort_topk,
        calibrate=cfg.test.calibration,
    )
    print(metrics)
    return metrics


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(prog="python -m titanet_torch", description="titanet_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="train a model (reference-compatible YAML)")
    p_train.add_argument("-p", "--params", default=None, help="path to parameters .yml")
    p_eval = sub.add_parser("eval", help="verification EER/minDCF from a checkpoint")
    p_eval.add_argument("-p", "--params", default=None)
    p_eval.add_argument("-c", "--checkpoint-dir", required=True)
    p_eval.add_argument("-e", "--epoch", type=int, default=None)
    for p in (p_train, p_eval):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.params)
    if args.cmd == "train":
        train(cfg, device=args.device)
    elif args.cmd == "eval":
        evaluate_checkpoint(cfg, args.checkpoint_dir, args.epoch, device=args.device)


if __name__ == "__main__":
    main()
