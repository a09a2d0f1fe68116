"""Command line of the port (port of ``titanet_tpu/cli.py``):

    python -m titanet_torch train   -p params.yml
    python -m titanet_torch eval    -p params.yml -c <run dir>
    python -m titanet_torch infer   -p params.yml -c <run dir> --audio <files or dirs> -o emb.npz
    python -m titanet_torch trials  -p params.yml -c <run dir> --trial-file veri_test2.txt
    python -m titanet_torch diarize -p params.yml -c <run dir> --audio conv.wav --rttm out.rttm

The same YAML schema as the JAX package drives the model, the loss, the
data and the augmentation (``-p`` also takes a ``.json`` file of the same
schema, which needs no PyYAML). Everything runs on the card (``--device
cuda``, the default) unless the caller names the CPU. ``infer``,
``trials`` and ``diarize`` restore a checkpoint of ``train`` (the EMA
weights when the run kept them) and embed through
:class:`titanet_torch.train.extractor.SpeakerEmbedder`; the HTTP speaker
service is :mod:`titanet_torch.serve`.

The frontend always takes the fused log-mel route, on either device: the
kernel on the card (at ``audio.frontend_precision: highest`` its f32 mode,
which agrees with plain torch to rounding), its plain version on the CPU.
So a CPU run computes what the card's kernel does, and
``audio.use_pallas_fused`` (the JAX package's switch for its TPU kernel) is
not read.

Every model family of the JAX package trains, evaluates and serves here
(:func:`build_model`). ``generic.device_corpus`` keeps one int16 corpus on
the device and feeds the train, validation, test and cohort loaders from
it (:func:`_attach_device_corpus`); ``augmentation.noise.download`` and
``augmentation.rir.download`` fetch MUSAN and the RIR corpus when their
directory holds no wav; ``figures.enabled``, ``infer --fig`` and ``trials
--det-out`` draw their figures (:mod:`titanet_torch.utils.viz`).

``train`` is data-parallel over ranks, one device each
(:mod:`titanet_torch.parallel`), with the JAX package's semantics:
global-batch BatchNorm, the gradient mean over the global batch and random
draws over it, so that P ranks compute the step of one process fed the
concatenated batch. Two ways to start the ranks:

- a launcher starts P processes with the JAX package's environment
  contract (``TITANET_COORDINATOR``, ``TITANET_NUM_PROCESSES``,
  ``TITANET_PROCESS_ID``) or under ``torchrun`` with
  ``TITANET_DISTRIBUTED=auto``. :func:`main` joins the process group
  before it touches a device (NCCL on the card, gloo with ``--device
  cpu``); each rank reads its own share of the train batches
  (``training.batch_size`` rows each: global batch ``P * batch_size``),
  and with ``generic.device_corpus`` uploads only its static share of the
  train corpus. ``mesh.num_devices``, if set, must equal P;
- ``mesh.num_devices: N > 1`` in a process without a launcher starts N
  local ranks (this process is rank 0; one card each, or the CPU). Each
  reads the same batches and keeps its rows, so the global batch stays
  ``training.batch_size``, as in the JAX package's one-process mesh;
  ``mesh.num_devices`` left at None does so over every visible card (on
  ``--device cuda``), as the JAX mesh takes every visible device.

Only rank 0 writes checkpoints, metrics, event files and figures.

``generic.compilation_cache_dir`` keeps the compiled kernels in that
directory (:func:`titanet_torch.utils.enable_compilation_cache`), read by
``train`` and by every command that restores a checkpoint, as the JAX CLI
reads it. On the card the embedding and evaluation steps run as CUDA
graphs, one a shape (:mod:`titanet_torch.train.capture`).
"""

from __future__ import annotations

import argparse
import contextlib
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
from titanet_torch.data.audio_io import read_mono
from titanet_torch.losses.heads import build_head
from titanet_torch.models import (
    DumbConvNet,
    DVectorBaseline,
    get_conformer,
    get_ecapa,
    get_resnet,
    get_titanet,
    get_xvector,
)
from titanet_torch.models.common import finish
from titanet_torch.ops.augment import AugmentConfig
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.parallel import distributed as pd
from titanet_torch.parallel import make_mesh, maybe_initialize_distributed
from titanet_torch.parallel.shard_map_step import replicate_state
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train.extractor import SpeakerEmbedder
from titanet_torch.train.loop import run_verification, training_loop
from titanet_torch.train.state import create_train_state, ema_eval_state, make_optimizer
from titanet_torch.utils import (
    ConsoleLogger,
    JsonlLogger,
    TensorBoardLogger,
    WandbLogger,
    chart_dependencies,
    enable_compilation_cache,
    set_seed,
)

def _dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.training.dtype == "bfloat16" else None


def build_model(cfg: Config, dtype=None, device="cuda", generator: Optional[torch.Generator] = None):
    """The model ``cfg`` selects, on ``device``, weights drawn from
    ``generator``, with the JAX package's precedence (reference
    src/train.py:87-121, the families beyond the reference slotted in
    before the TitaNet default): ``dumb``, ``baseline`` (d-vector),
    ``ecapa``, ``xvector``, ``resnet``, ``conformer``, then TitaNet S/M/L
    from ``cfg.titanet``."""
    widths = dict(embedding_size=cfg.generic.embedding_size, n_mels=cfg.audio.spectrogram.n_mels, dtype=dtype)
    common = dict(widths, device=device, generator=generator)
    if cfg.dumb.enabled:
        model = DumbConvNet(hidden_size=cfg.dumb.hidden_size, n_layers=cfg.dumb.n_layers, **widths)
        return finish(model, device, generator)
    if cfg.baseline.enabled:
        model = DVectorBaseline(n_lstm_layers=cfg.baseline.n_layers, hidden_size=cfg.baseline.hidden_size,
                                lstm_average=cfg.baseline.average, segment_length=cfg.baseline.segment_length,
                                **widths)
        return finish(model, device, generator)
    if cfg.ecapa.enabled:
        return get_ecapa(channels=cfg.ecapa.channels, attention_hidden_size=cfg.ecapa.attention_hidden_size,
                         **common)
    if cfg.xvector.enabled:
        return get_xvector(hidden_size=cfg.xvector.hidden_size, frame_out=cfg.xvector.frame_out, **common)
    if cfg.resnet.enabled:
        return get_resnet(depth=cfg.resnet.depth, base_channels=cfg.resnet.base_channels, **common)
    if cfg.conformer.enabled:
        c = cfg.conformer
        return get_conformer(num_blocks=c.num_blocks, dim=c.dim, num_heads=c.num_heads, ff_hidden=c.ff_hidden,
                             conv_kernel=c.conv_kernel, dropout=c.dropout, **common)
    return get_titanet(
        n_mega_blocks=cfg.titanet.n_mega_blocks,
        model_size=cfg.titanet.model_size,
        attention_hidden_size=cfg.titanet.attention_hidden_size,
        simple_pool=cfg.titanet.simple_pool,
        dropout=cfg.titanet.dropout,
        **common,
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
        from titanet_torch.data.acquire import fetch_musan

        fetch_musan(no.corpora_path, subset="noise")
        paths = tuple(str(p) for p in sorted(Path(no.corpora_path).rglob("*.wav")))
    if not paths:
        raise FileNotFoundError(
            f"augmentation.noise.source=files but no wavs under {no.corpora_path!r} "
            "(set augmentation.noise.download: true to fetch MUSAN)"
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


def _attach_device_corpus(cfg: Config, loaders, device) -> None:
    """``generic.device_corpus``: build ONE flat int16 corpus on ``device``
    for each root dataset the loaders read (train, validation, test and
    cohort share one) and switch every loader to descriptor batches
    (:mod:`titanet_torch.data.device_corpus`). Process-cached, so runs
    that rebuild an identical synthetic corpus reuse the uploaded tensor.

    A sharded train loader (the first, one rank of a launcher's P):
    this rank decodes and uploads ONLY that loader's static utterance
    share (``device_shard_root_indices``), so its device holds ~1/P of the
    corpus; the validation, test and cohort loaders stay host-fed (they
    run a few times a run; the train path is the per-step cost)."""
    from titanet_torch.data.device_corpus import DeviceCorpus, corpus_cache_key, resolve_base

    if loaders[0].num_shards > 1:
        train_loader = loaders[0]
        root, _ = resolve_base(train_loader.dataset)
        corpus = DeviceCorpus.build(
            root, cfg.audio.sample_rate, device=device,
            cache_key=corpus_cache_key(root) + ("shard", train_loader.shard_id, train_loader.num_shards),
            root_indices=train_loader.device_shard_root_indices(),
        )
        train_loader.attach_device_corpus(corpus)
        return
    corpora = {}
    for loader in loaders:
        root, _ = resolve_base(loader.dataset)
        if id(root) not in corpora:
            corpora[id(root)] = DeviceCorpus.build(root, cfg.audio.sample_rate, device=device,
                                                   cache_key=corpus_cache_key(root))
        loader.attach_device_corpus(corpora[id(root)])


def _ranks_to_start(cfg: Config, dev: torch.device, world: int) -> int:
    """How many local ranks ``train`` starts for ``mesh.num_devices``: 0
    under a launcher (``world`` > 1: ``num_devices``, if set, must equal
    it) or for one device. Without a launcher, ``num_devices: N > 1`` starts
    N, which must divide ``training.batch_size`` and, on the card, be at
    most the visible cards; None means every visible card, as the JAX
    package's mesh takes every visible device (on ``cuda`` with no index;
    the CPU and a named card are one device)."""
    n = cfg.mesh.num_devices
    if world > 1:
        if n is not None and n != world:
            raise ValueError(f"mesh.num_devices is {n} but the launcher started {world} ranks")
        return 0
    if n is None:
        n = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    if n <= 1:
        return 0
    if cfg.training.batch_size % n:
        raise ValueError(f"training.batch_size {cfg.training.batch_size} does not split over "
                         f"mesh.num_devices {n} ranks (remainder {cfg.training.batch_size % n})")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"mesh.num_devices is {n} but {torch.cuda.device_count()} CUDA devices are visible")
    return n


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


def _loaders(cfg: Config, train_ds, val_ds, test_ds, noise_mix, shard=(0, 1)):
    """The loaders :func:`train` runs: ``(train, validation, test)``, the
    last two None where ``cfg`` turns them off. ``shard``: ``(rank,
    ranks)`` of the train loader's round-robin batch shares (the
    validation and test loaders are never sharded)."""
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
        if cfg.augmentation.rir.download and not list(Path(rir_root).rglob("*.wav")):
            from titanet_torch.data.acquire import fetch_rir_corpus

            fetch_rir_corpus(rir_root)
        rir_paths = tuple(str(p) for p in sorted(Path(rir_root).rglob("*.wav")))
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
        transport_dtype=cfg.training.transport_dtype,
        shard_id=shard[0], num_shards=shard[1], **cache_kw,
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
    """Train as ``cfg`` says; returns the final train state (rank 0's when
    ``mesh.num_devices`` starts ranks). Checkpoints and ``metrics.jsonl``
    go under ``training.checkpoints_path/<run>``. Under a launcher's
    process group this rank trains on its share of each global batch (the
    module docstring)."""
    dev = resolve_device(device)
    n = _ranks_to_start(cfg, dev, pd.world()[1])
    if n:
        return _train_on_local_ranks(cfg, dev, n)
    return _train(cfg, dev, rows_of_each_batch=False)


def _train(cfg: Config, dev: torch.device, rows_of_each_batch: bool):
    """:func:`train` in this process, on the mesh of the live process group
    (size 1 without one): a sharded train loader (one batch a rank), or,
    with ``rows_of_each_batch``, every rank's loader reads the same batches
    and each rank keeps its rows."""
    mesh = make_mesh(None, cfg.mesh.data_axis, device=dev)
    dev = mesh.device
    if cfg.generic.compilation_cache_dir:
        enable_compilation_cache(cfg.generic.compilation_cache_dir)
    set_seed(cfg.generic.seed)
    frontend = _frontend(cfg)
    train_ds, val_ds, test_ds, n_speakers = _datasets(cfg, cfg.test.enabled)
    noise_mix = _noise_mix_config(cfg)
    shard = (0, 1) if rows_of_each_batch else (mesh.rank, mesh.size)
    train_loader, val_loader, test_loader = _loaders(cfg, train_ds, val_ds, test_ds, noise_mix, shard)
    cohort_loader, cohort_topk = _cohort_loader(cfg, train_ds) if cfg.test.enabled else (None, None)
    if cfg.generic.device_corpus:
        _attach_device_corpus(
            cfg, [l for l in (train_loader, val_loader, test_loader, cohort_loader) if l is not None], dev,
        )

    model, head, state = _new_state(cfg, n_speakers, dev, max(len(train_loader), 1))
    replicate_state(state, mesh)  # equal already (same seeds): rank 0's, to the bit
    main_rank = mesh.rank == 0
    if cfg.generic.chart_dependencies and main_rank:
        chart_dependencies(model, n_mels=cfg.audio.spectrogram.n_mels)

    run_name = cfg.training.run_name
    if run_name is None and cfg.training.resume:
        # resume the most recent run under checkpoints_path
        base = cfg.training.checkpoints_path
        if os.path.isdir(base):
            runs = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
            run_name = runs[-1] if runs else None
    if run_name is None:
        # another rank's clock-made name may differ by a second: it writes nothing
        run_name = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    console = ConsoleLogger(enabled=cfg.generic.log_console and main_rank)
    jsonl = JsonlLogger(os.path.join(cfg.training.checkpoints_path, run_name, "metrics.jsonl")
                        if main_rank else None)
    wandb = WandbLogger(
        enabled=cfg.wandb.enabled and main_rank, api_key_file=cfg.wandb.api_key_file,
        project=cfg.wandb.project, entity=cfg.wandb.entity or None,
        name=run_name, config=cfg.to_dict(),
    )
    tb = TensorBoardLogger(
        os.path.join(cfg.generic.tensorboard_dir, run_name)
        if cfg.generic.tensorboard_dir and main_rank else None
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
            figures_path=cfg.figures.path if cfg.figures.enabled else None,
            reduction_method=cfg.figures.reduction_method,
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
            mesh=mesh,
        )
    finally:
        wandb.finish()
        tb.finish()
    return state


@contextlib.contextmanager
def _local_group(rank: int, world: int, port: int, dev: torch.device):
    """Join the local ranks' group through the launcher contract (NCCL on
    the card, gloo on the CPU), and leave it and the contract's variables
    on the way out."""
    contract = dict(TITANET_COORDINATOR=f"127.0.0.1:{port}", TITANET_NUM_PROCESSES=str(world),
                    TITANET_PROCESS_ID=str(rank))
    saved = {k: os.environ.get(k) for k in contract}
    os.environ.update(contract)
    try:
        maybe_initialize_distributed(verbose=False, backend="nccl" if dev.type == "cuda" else "gloo")
        try:
            yield
        finally:
            pd.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _local_rank_main(rank: int, world: int, port: int, cfg_dict: dict, device: str) -> None:
    """Entry of a local rank that :func:`_train_on_local_ranks` started."""
    dev = torch.device(device)
    with _local_group(rank, world, port, dev):
        _train(Config.from_dict(cfg_dict), dev, rows_of_each_batch=True)


def _train_on_local_ranks(cfg: Config, dev: torch.device, n: int):
    """``mesh.num_devices: n`` without a launcher: start ranks 1..n-1 as
    spawned processes, train as rank 0 here, and wait for the others
    (within the group's timeout); a failed rank fails the run."""
    import torch.multiprocessing as mp

    port = pd.free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_local_rank_main, args=(r, n, port, cfg.to_dict(), dev.type))
             for r in range(1, n)]
    for p in procs:
        p.start()
    ok = False
    try:
        with _local_group(0, n, port, dev):
            state = _train(cfg, dev, rows_of_each_batch=True)
        ok = True
    finally:
        deadline = pd.timeout().total_seconds()
        for p in procs:
            p.join(timeout=deadline if ok else 5)
            if p.is_alive():
                p.terminate()
                p.join()
    failed = [r for r, p in enumerate(procs, 1) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"local ranks {failed} of {n} failed (exit codes "
                           f"{[procs[r - 1].exitcode for r in failed]})")
    return state


def _rebuild_state(cfg: Config, n_speakers: int, device="cuda"):
    """(model, head, frontend, state) shaped as training built them, to
    restore a checkpoint into."""
    if cfg.generic.compilation_cache_dir:
        enable_compilation_cache(cfg.generic.compilation_cache_dir)
    dev = resolve_device(device)
    model, head, state = _new_state(cfg, n_speakers, dev)
    return model, head, _frontend(cfg), state


def _restore_for_eval(cfg: Config, n_speakers: int, checkpoint_dir: str, epoch: Optional[int], device):
    """``(state, frontend, epoch)``: the checkpoint of ``epoch`` (the newest
    under ``checkpoint_dir`` when None) restored into a state built as
    training built it, with the EMA weights when the run kept them."""
    _, _, frontend, state = _rebuild_state(cfg, n_speakers, device=device)
    if epoch is None:
        restored, epoch = ckpt.restore_latest(checkpoint_dir, state)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    else:
        ckpt.restore_checkpoint(checkpoint_dir, epoch, state)
    return ema_eval_state(state), frontend, epoch


def evaluate_checkpoint(cfg: Config, checkpoint_dir: str, epoch: Optional[int] = None, device="cuda"):
    """Verification EER/minDCF of a saved checkpoint (the newest under
    ``checkpoint_dir`` unless ``epoch`` is given), with the EMA weights when
    the run kept them."""
    train_ds, _, test_ds, n_speakers = _datasets(cfg, True)
    state, frontend, _ = _restore_for_eval(cfg, n_speakers, checkpoint_dir, epoch, device)
    loader = DataLoader(
        test_ds, batch_size=cfg.validation.batch_size, shuffle=False,
        drop_last=False, chunk=ChunkConfig(enabled=False),
        sample_rate=cfg.audio.sample_rate, seed=cfg.generic.seed,
    )
    cohort_loader, cohort_topk = _cohort_loader(cfg, train_ds)
    metrics = run_verification(
        state, loader, frontend=frontend,
        mindcf_p_target=cfg.test.mindcf_p_target,
        mindcf_c_fa=cfg.test.mindcf_c_fa, mindcf_c_miss=cfg.test.mindcf_c_miss,
        console=ConsoleLogger(enabled=True),
        cohort_loader=cohort_loader, cohort_topk=cohort_topk,
        calibrate=cfg.test.calibration,
    )
    print(metrics)
    return metrics


def infer_checkpoint(
    cfg: Config,
    checkpoint_dir: str,
    epoch: Optional[int] = None,
    audio_paths: Optional[list] = None,
    split: str = "test",
    num_utterances: int = 64,
    out_path: Optional[str] = None,
    fig_path: Optional[str] = None,
    device="cuda",
):
    """Embed utterances with a saved checkpoint (reference ``learn.infer``,
    src/learn.py:462-493). With ``audio_paths``, wav/flac files of any
    length through ``SpeakerEmbedder`` (labels: the file stems); otherwise
    the first ``num_utterances`` of the config's ``split`` through
    :func:`titanet_torch.train.loop.infer` (labels: speaker ids). Saves
    ``embeddings`` and ``labels`` to ``out_path`` (.npz) when given.
    Returns ``(embeddings [N, E] f32, labels [N])``."""
    _, val_ds, test_ds, n_speakers = _datasets(cfg, True)
    state, frontend, _ = _restore_for_eval(cfg, n_speakers, checkpoint_dir, epoch, device)
    if audio_paths:
        wavs = [read_mono(p, cfg.audio.sample_rate) for p in audio_paths]
        embeddings = SpeakerEmbedder(state.model, frontend, device=device).embed(wavs)
        labels = np.asarray([os.path.splitext(os.path.basename(p))[0] for p in audio_paths])
    else:
        from titanet_torch.train.loop import infer

        dataset = {"val": val_ds, "test": test_ds}.get(split)
        if dataset is None or len(dataset) == 0:
            raise ValueError(f"split {split!r} is empty or disabled in the config")
        embeddings, speakers = infer(
            state, dataset, list(range(min(num_utterances, len(dataset)))),
            frontend=frontend, sample_rate=cfg.audio.sample_rate,
            batch_size=cfg.validation.batch_size,
        )
        labels = np.asarray(speakers)
    if out_path:
        np.savez(out_path, embeddings=embeddings, labels=labels)
        print(f"[saved {len(embeddings)} embeddings -> {out_path}]")
    if fig_path:
        from titanet_torch.utils.viz import visualize_embeddings

        if visualize_embeddings(embeddings, labels, reduction_method=cfg.figures.reduction_method,
                                save=fig_path):
            print(f"[saved projection figure -> {fig_path}]")
    return embeddings, labels


def trials_checkpoint(
    cfg: Config,
    checkpoint_dir: str,
    trial_file: str,
    epoch: Optional[int] = None,
    audio_root: Optional[str] = None,
    cohort_npz: Optional[str] = None,
    cohort_topk: Optional[int] = None,
    scores_out: Optional[str] = None,
    det_out: Optional[str] = None,
    device="cuda",
):
    """Score a VoxCeleb (``veri_test2.txt``) or Kaldi (``trials``) trial
    list with a saved checkpoint (:mod:`titanet_torch.train.trials`).
    ``cohort_npz`` (an ``infer -o`` output) turns on S-norm, and
    ``cohort_topk`` AS-norm. Returns the metrics dict (EER, minDCF,
    min-Cllr, counts)."""
    from titanet_torch.train.trials import evaluate_trials

    _, _, _, n_speakers = _datasets(cfg, True)
    state, frontend, epoch = _restore_for_eval(cfg, n_speakers, checkpoint_dir, epoch, device)
    cohort = np.load(cohort_npz)["embeddings"] if cohort_npz else None
    metrics = evaluate_trials(
        trial_file, SpeakerEmbedder(state.model, frontend, batch_size=cfg.validation.batch_size, device=device),
        audio_root=audio_root, sample_rate=cfg.audio.sample_rate,
        cohort_embeddings=cohort, cohort_topk=cohort_topk,
        p_target=cfg.test.mindcf_p_target, c_fa=cfg.test.mindcf_c_fa,
        c_miss=cfg.test.mindcf_c_miss, scores_out=scores_out, det_out=det_out,
    )
    print(
        f"[trials epoch {epoch}] eer={metrics['eer']:.4f} "
        f"mindcf@{cfg.test.mindcf_p_target}={metrics['mindcf']:.4f} "
        f"min_cllr={metrics['min_cllr']:.4f} "
        f"({metrics['n_trials']} trials / {metrics['n_target']} target / "
        f"{metrics['n_files']} files)"
    )
    return metrics


def diarize_checkpoint(
    cfg: Config,
    checkpoint_dir: str,
    audio_paths: list,
    epoch: Optional[int] = None,
    window_s: float = 1.5,
    hop_s: float = 0.75,
    n_speakers: Optional[int] = None,
    max_speakers: int = 8,
    vad: bool = False,
    clustering: str = "nmesc",
    ahc_threshold: float = 0.6,
    overlap_threshold: Optional[float] = None,
    overlap_margin: float = 0.15,
    rttm_out: Optional[str] = None,
    device="cuda",
):
    """Who spoke when in each audio file, with a saved checkpoint (windowed
    embeddings and clustering, :mod:`titanet_torch.train.diarize`). Prints
    the segments of each file and, with ``rttm_out``, writes one RTTM file
    (uri: the file's stem). Returns ``{path: [Segment, ...]}``."""
    from titanet_torch.train.diarize import diarize, write_rttm

    _, _, _, n_train_speakers = _datasets(cfg, True)
    state, frontend, _ = _restore_for_eval(cfg, n_train_speakers, checkpoint_dir, epoch, device)
    embedder = SpeakerEmbedder(state.model, frontend, batch_size=cfg.validation.batch_size, device=device)
    if rttm_out and os.path.exists(rttm_out):
        os.remove(rttm_out)  # write_rttm appends per uri
    results = {}
    for path in audio_paths:
        segments = diarize(
            read_mono(path, cfg.audio.sample_rate), cfg.audio.sample_rate, embedder,
            window_s=window_s, hop_s=hop_s, n_speakers=n_speakers, max_speakers=max_speakers,
            vad=vad, clustering=clustering, ahc_threshold=ahc_threshold,
            overlap_threshold=overlap_threshold, overlap_margin=overlap_margin,
        )
        results[path] = segments
        print(f"[{path}: {len(segments)} segments, {len({s.speaker for s in segments})} speakers]")
        for seg in segments:
            print(f"  {seg.start:8.2f}s - {seg.end:8.2f}s  speaker {seg.speaker}")
        if rttm_out:
            write_rttm(segments, rttm_out, uri=os.path.splitext(os.path.basename(path))[0])
    if rttm_out:
        print(f"[rttm written to {rttm_out}]")
    return results


def _audio_files(paths) -> list:
    """Files as given; a directory expands to its wav/flac files, walked in
    sorted order."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in sorted(os.walk(p)):
                out += [os.path.join(root, f) for f in sorted(files) if f.lower().endswith((".wav", ".flac"))]
        else:
            out.append(p)
    return out


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(prog="python -m titanet_torch", description="titanet_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="train a model (reference-compatible YAML)")
    p_train.add_argument("-p", "--params", default=None, help="path to parameters .yml")
    p_eval = sub.add_parser("eval", help="verification EER/minDCF from a checkpoint")
    p_infer = sub.add_parser("infer", help="embed utterances/audio files with a checkpoint "
                             "(reference learn.infer)")
    p_trials = sub.add_parser("trials", help="score a standard trial list (VoxCeleb veri_test2 / "
                              "Kaldi format) with a checkpoint")
    p_diar = sub.add_parser("diarize", help="who-spoke-when over audio files (windowed "
                            "embeddings + clustering), optional RTTM output")
    for p in (p_eval, p_infer, p_trials, p_diar):
        p.add_argument("-p", "--params", default=None)
        p.add_argument("-c", "--checkpoint-dir", required=True)
        p.add_argument("-e", "--epoch", type=int, default=None)
    p_infer.add_argument("--audio", nargs="*", default=None,
                         help="wav/flac files (or directories) to embed; omit to embed dataset utterances")
    p_infer.add_argument("--split", choices=("val", "test"), default="test")
    p_infer.add_argument("-n", "--num-utterances", type=int, default=64)
    p_infer.add_argument("-o", "--out", default=None, help="output .npz (embeddings + labels)")
    p_infer.add_argument("--fig", default=None, help="save a 2-D projection scatter PNG")
    p_trials.add_argument("--trial-file", required=True,
                          help="'<0|1> <enroll> <test>' or '<enroll> <test> target|nontarget' per line")
    p_trials.add_argument("--audio-root", default=None, help="directory trial paths are relative to")
    p_trials.add_argument("--cohort", default=None,
                          help="impostor-cohort .npz from `infer -o` (enables S-norm)")
    p_trials.add_argument("--cohort-topk", type=int, default=None,
                          help="AS-norm: use only each side's top-K cohort scores")
    p_trials.add_argument("--det-out", default=None, help="write a DET-curve PNG for the trial scores")
    p_trials.add_argument("-o", "--scores-out", default=None, help="write '<enroll> <test> <score>' lines")
    p_diar.add_argument("--audio", nargs="+", required=True, help="wav/flac files to diarize")
    p_diar.add_argument("--rttm", default=None,
                        help="write NIST RTTM SPEAKER lines here (uri = audio file stem)")
    p_diar.add_argument("--window", type=float, default=1.5)
    p_diar.add_argument("--hop", type=float, default=0.75)
    p_diar.add_argument("--known-k", type=int, default=None,
                        help="fix the speaker count (default: NME-SC auto)")
    p_diar.add_argument("--max-speakers", type=int, default=8)
    p_diar.add_argument("--vad", action="store_true", help="place windows only inside energy-VAD speech")
    p_diar.add_argument("--clustering", choices=("nmesc", "ahc"), default="nmesc")
    p_diar.add_argument("--ahc-threshold", type=float, default=0.6)
    p_diar.add_argument("--overlap", type=float, default=None, metavar="TH",
                        help="emit overlapped second speakers (runner-up centroid threshold; calibrate "
                        "via train.diarize.calibrate_overlap_threshold)")
    p_diar.add_argument("--overlap-margin", type=float, default=0.15)
    for p in (p_train, p_eval, p_infer, p_trials, p_diar):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    # a launcher's ranks join their process group before any device use
    maybe_initialize_distributed(backend="gloo" if torch.device(args.device).type == "cpu" else "nccl")
    cfg = load_config(args.params)
    if args.cmd == "train":
        return train(cfg, device=args.device)
    if args.cmd == "eval":
        return evaluate_checkpoint(cfg, args.checkpoint_dir, args.epoch, device=args.device)
    if args.cmd == "infer":
        return infer_checkpoint(
            cfg, args.checkpoint_dir, args.epoch,
            audio_paths=_audio_files(args.audio) if args.audio else None,
            split=args.split, num_utterances=args.num_utterances,
            out_path=args.out, fig_path=args.fig, device=args.device,
        )
    if args.cmd == "trials":
        return trials_checkpoint(
            cfg, args.checkpoint_dir, args.trial_file, args.epoch,
            audio_root=args.audio_root, cohort_npz=args.cohort, cohort_topk=args.cohort_topk,
            scores_out=args.scores_out, det_out=args.det_out, device=args.device,
        )
    return diarize_checkpoint(
        cfg, args.checkpoint_dir, args.audio, args.epoch,
        window_s=args.window, hop_s=args.hop, n_speakers=args.known_k,
        max_speakers=args.max_speakers, vad=args.vad, clustering=args.clustering,
        ahc_threshold=args.ahc_threshold, overlap_threshold=args.overlap,
        overlap_margin=args.overlap_margin, rttm_out=args.rttm, device=args.device,
    )

if __name__ == "__main__":
    main()
