"""Typed configuration (the port's own copy of ``titanet_tpu/config.py``).

The same dataclasses, keys and defaults as the JAX package, so every
``configs/*.yml`` loads to the same ``to_dict()``. PyYAML is imported only
by :meth:`Config.from_yaml`; a ``Config`` built in code needs no YAML.

Of the keys that steer the JAX package's compiler,
``generic.compilation_cache_dir`` keeps the port's compiled kernels in
that directory (:func:`titanet_torch.utils.enable_compilation_cache`);
``generic.fast_prng`` (JAX's PRNG implementation; torch's CUDA generator
has one, Philox) and ``titanet.scan_blocks`` as a layout of the model (the
port runs its mega-blocks one after another either way) are accepted and
have no effect. The weights of a ``scan_blocks`` run load into the port's
model (:func:`titanet_torch.utils.weights.load_jax_variables` unstacks
them).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional


def _build(cls, data: dict):
    """Recursively build a dataclass from a (possibly partial) dict."""
    if data is None:
        data = {}
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise ValueError(f"Unknown config key {key!r} for {cls.__name__}")
        ftype = fields[key].type
        if dataclasses.is_dataclass(_resolve(ftype)) and isinstance(value, dict):
            kwargs[key] = _build(_resolve(ftype), value)
        else:
            kwargs[key] = value
    # Fill nested dataclass defaults for unspecified sections
    for name, f in fields.items():
        if name not in kwargs and dataclasses.is_dataclass(_resolve(f.type)):
            kwargs[name] = _resolve(f.type)()
    return cls(**kwargs)


_TYPES: dict = {}


def _resolve(tp):
    if isinstance(tp, str):
        # PEP 563 stores the annotation source text: 'x: "Foo"' -> '"Foo"'
        return _TYPES.get(tp.strip("\"'"), tp)
    return tp


def _register(cls):
    _TYPES[cls.__name__] = cls
    return cls


@_register
@dataclass
class OptimizerConfig:
    type: str = "adam"
    start_lr: float = 1e-3
    scheduler: bool = False  # cosine decay to end_lr over all epochs
    end_lr: float = 1e-5
    weight_decay: float = 0.0
    # additions (absent in the reference)
    warmup_epochs: int = 0
    grad_clip_norm: Optional[float] = None
    # gradient accumulation: average grads over k micro-batches, update
    # params every k-th step (optax.MultiSteps; effective batch = k x B)
    accumulate_steps: int = 1


@_register
@dataclass
class TrainingConfig:
    optimizer: "OptimizerConfig" = field(default_factory=OptimizerConfig)
    checkpoints_path: str = "./checkpoints"
    checkpoints_frequency: Optional[int] = 25  # epochs
    batch_size: int = 8
    epochs: int = 250
    loss: str = "ce"
    # additions (absent in the reference)
    resume: bool = False  # resume from latest checkpoint if present
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    # run directory name under checkpoints_path; default = timestamp.
    # With resume=true and no run_name, the latest existing run is resumed.
    run_name: Optional[str] = None
    # speaker-balanced batches (n_speakers, m_utterances with
    # n*m == batch_size); recommended for the ge2e loss. None = off.
    balanced_speakers: Optional[int] = None
    balanced_utterances: Optional[int] = None
    # best-checkpoint tracking (saved at step 0) + optional early stopping
    track_best: str = "val/avg_loss"
    early_stop_patience: Optional[int] = None  # validations without improvement
    # waveform wire format host->device for the TRAIN loader: int16 halves
    # the transfer (sources are 16-bit PCM); val/test stay float32
    transport_dtype: str = "int16"
    # weight EMA decay per step (0.0 = off). When on, validation and the
    # final verification test score the EMA weights (the deployable model)
    ema_decay: float = 0.0


@_register
@dataclass
class DatasetConfig:
    root: str = "./data"
    # librispeech | vctk | voxceleb1 | voxceleb2 | synthetic, or a
    # "+"-joined union ("librispeech+vctk") trained as ONE corpus with
    # per-source namespaced speakers (data.ConcatSpeakerDataset)
    name: str = "librispeech"
    # synthetic-corpus size + difficulty (ignored for on-disk corpora);
    # the difficulty knobs make EER a discriminative benchmark — see
    # SyntheticSpeakerDataset
    synthetic_speakers: int = 8
    synthetic_utterances: int = 12
    synthetic_seed: int = 0  # corpus seed, independent of generic.seed
    synthetic_formant_jitter: Optional[float] = None
    synthetic_noise: float = 0.01
    synthetic_reverb_prob: float = 0.0
    synthetic_pitch_jitter: float = 0.05
    synthetic_f0_min: float = 90.0
    synthetic_f0_max: float = 280.0


@_register
@dataclass
class FiguresConfig:
    enabled: bool = False
    path: str = "./figures"
    reduction_method: str = "svd"


@_register
@dataclass
class ValidationConfig:
    enabled: bool = True
    every: int = 2
    batch_size: int = 8
    num_utterances_per_speaker: int = 10


@_register
@dataclass
class TestConfig:
    enabled: bool = True
    mindcf_p_target: float = 0.01
    mindcf_c_fa: float = 1.0
    mindcf_c_miss: float = 1.0
    num_speakers: int = 10
    num_utterances_per_speaker: int = 10
    # Open-set protocol (beyond the reference): when true, test speakers
    # contribute ONLY their test utterances — nothing to train/val — so
    # verification measures unseen identities. The reference's split
    # (default, false) leaves a test speaker's surplus utterances in the
    # TRAIN split (src/datasets.py:204-217), which makes verification
    # closed-set whenever utterances/speaker > val_ups + test_ups.
    exclusive_speakers: bool = False
    # Verification score normalization (beyond the reference): "none",
    # "snorm" (symmetric S-norm over the full cohort), or "asnorm"
    # (adaptive: per-embedding top-K cohort statistics). The cohort is
    # `cohort_size` utterances sampled from the TRAIN split. NOTE: under
    # the default (reference-parity) split the train split may contain
    # surplus utterances of test SPEAKERS (see exclusive_speakers above),
    # so the cohort is only speaker-disjoint from test when
    # exclusive_speakers is true or the corpus has no surplus.
    score_norm: str = "none"
    cohort_size: int = 256
    asnorm_topk: int = 100
    # Logistic LLR calibration fitted on cohort trials (beyond the
    # reference): reports test/cllr, test/min_cllr, test/act_dcf
    # (train/calibration.py). Uses the same train-split cohort as
    # score_norm (built even when score_norm is "none").
    calibration: bool = False


@_register
@dataclass
class SphereLossConfig:
    margin: float = 4.0
    scale: Optional[float] = None
    # ramp the margin 0 -> target over the first N epochs (0 = off);
    # margin warmup stabilizes angular-margin training (an addition,
    # absent in the reference)
    margin_warmup_epochs: int = 0
    # K > 1: Sub-center variant (Deng et al., ECCV 2020) — per-class
    # cosine is the max over K prototype columns (an addition)
    sub_centers: int = 1


@_register
@dataclass
class CosLossConfig:
    margin: float = 0.2
    scale: float = 64.0
    margin_warmup_epochs: int = 0  # see SphereLossConfig
    sub_centers: int = 1  # see SphereLossConfig


@_register
@dataclass
class ArcLossConfig:
    margin: float = 0.2
    scale: float = 30.0
    margin_warmup_epochs: int = 0  # see SphereLossConfig
    sub_centers: int = 1  # see SphereLossConfig


@_register
@dataclass
class LossConfig:
    sphere: "SphereLossConfig" = field(default_factory=SphereLossConfig)
    cos: "CosLossConfig" = field(default_factory=CosLossConfig)
    arc: "ArcLossConfig" = field(default_factory=ArcLossConfig)


@_register
@dataclass
class DumbConfig:
    enabled: bool = False
    n_layers: int = 10
    hidden_size: int = 256


@_register
@dataclass
class TitanetConfig:
    enabled: bool = True
    model_size: str = "s"
    n_mega_blocks: Optional[int] = 17
    attention_hidden_size: int = 128
    simple_pool: bool = False
    dropout: float = 0.1
    # Run the mega-blocks as one lax.scan with [N]-stacked params: ~N-fold
    # smaller encoder HLO (compile time); param layout changes — see
    # models.stack_mega_block_params. Perf measured in BENCHMARKS.md. The
    # port's model ignores it; the stacked weights load (utils.weights).
    scan_blocks: bool = False


@_register
@dataclass
class BaselineConfig:
    enabled: bool = False
    n_layers: int = 3
    hidden_size: int = 768
    segment_length: int = 160
    average: bool = True


@_register
@dataclass
class EcapaConfig:
    # ECAPA-TDNN (arXiv:2005.07143) — second model family beyond the
    # reference. channels 512 -> ~6.2M params, 1024 -> ~14.7M.
    enabled: bool = False
    channels: int = 512
    attention_hidden_size: int = 128


@_register
@dataclass
class XvectorConfig:
    # x-vector TDNN (Snyder et al. 2018) — third model family beyond the
    # reference. Defaults are the paper scale (H=512, P=1500, ~4M params).
    enabled: bool = False
    hidden_size: int = 512
    frame_out: int = 1500


@_register
@dataclass
class ConformerConfig:
    # MFA-Conformer (arXiv:2203.15249) — fifth model family, the
    # attention-based archetype (beyond the reference). Defaults are the
    # paper's ~20M "Conformer (small)" scale.
    enabled: bool = False
    num_blocks: int = 6
    dim: int = 256
    num_heads: int = 4
    ff_hidden: int = 2048
    conv_kernel: int = 15
    dropout: float = 0.1


@_register
@dataclass
class DistillConfig:
    # Embedding-space knowledge distillation (beyond the reference): the
    # student trains with (1-alpha)*head_loss + alpha*(1 - cos(student_emb,
    # teacher_emb)) against a frozen trained teacher. Lets the fast
    # families (x-vector/ECAPA) inherit quality from the slow ones
    # (TitaNet/ResNet); measured effect in docs/eer_bench (bench17).
    enabled: bool = False
    # orbax run directory of the trained teacher (e.g.
    # ./checkpoints/eer_bench/bench12_ce_ema_seed42)
    teacher_checkpoint: str = ""
    # dotted-path overrides applied to THIS config to describe the
    # teacher's architecture/run, e.g.
    # {"xvector.enabled": false, "training.ema_decay": 0.99}
    teacher_overrides: Optional[dict] = None
    teacher_ema: bool = True  # use EMA weights when the checkpoint has them
    alpha: float = 0.5


@_register
@dataclass
class ResnetConfig:
    # ResNet r-vector (arXiv:1910.12592) — fourth model family beyond the
    # reference. depth 34 / base 32 is the r-vector scale (~6.3M params).
    enabled: bool = False
    depth: int = 34
    base_channels: int = 32


@_register
@dataclass
class WandbConfig:
    enabled: bool = False
    entity: str = ""
    project: str = "titanet"
    api_key_file: str = "./init/wandb_api_key_file"


@_register
@dataclass
class GenericConfig:
    seed: int = 42
    workers: int = 2
    log_console: bool = False
    chart_dependencies: bool = False
    embedding_size: int = 192
    # The JAX package's PRNG implementation choice (rbg vs threefry); the
    # port draws from torch generators and ignores it.
    fast_prng: bool = True
    # The persistent compilation cache: the port keeps its compiled kernels
    # there (utils.enable_compilation_cache); CUDA graphs live in-process.
    compilation_cache_dir: str = ""
    # Memoize decoded+resampled waveforms (int16 PCM, per loader) so epochs
    # >= 2 skip audio decode — the host pipeline's dominant cost
    # (bench_loader.py). The reference re-decoded every example every epoch
    # (src/datasets.py:283-294). Budget in MB of int16 PCM per loader.
    cache_waveforms: bool = False
    cache_budget_mb: int = 2048
    # TensorBoard event-file logging directory ("" = disabled). Unlike
    # W&B this sink is fully local (utils/tb_events.py writes stock
    # events.out.tfevents.* files with no tensorflow dependency); events
    # land under <tensorboard_dir>/<run_name>.
    tensorboard_dir: str = ""
    # Device-resident corpus (data/device_corpus.py): upload the whole
    # corpus as int16 PCM to device memory ONCE and gather/crop batch
    # windows on device — per-step host->device traffic drops to a ~KB
    # descriptor. For corpora that fit HBM (cap: 2^31 samples ~ 37 h @
    # 16 kHz) with no host-side waveform augmentation (speed/reverb/
    # noise-mix force the host loader; chunking + device-side
    # SpecAugment/noise stay eligible). Single-process only.
    device_corpus: bool = False


@_register
@dataclass
class SpectrogramConfig:
    n_fft: int = 512
    win_length: int = 25  # ms
    hop_length: int = 10  # ms
    n_mels: int = 80


@_register
@dataclass
class AudioConfig:
    sample_rate: int = 16000
    spectrogram: "SpectrogramConfig" = field(default_factory=SpectrogramConfig)
    # 'highest' (f32 DFT/mel products, torchaudio parity) or 'default'
    # (the fused log-mel kernel's bf16 tensor-core route on the card)
    frontend_precision: str = "highest"
    # The JAX package's switch for its fused log-mel TPU kernel. The port's
    # CLI does not read it: it always takes the fused route (the kernel on
    # the card, its plain version on the CPU; titanet_torch/cli.py), and
    # SpecAugment steps keep their own stretch-aware frontend regardless.
    use_pallas_fused: bool = False


@_register
@dataclass
class RirConfig:
    corpora_path: str = "./data/rirs"
    # fetch the OpenSLR-28 corpus when corpora_path has no .wav files
    # (reference Reverb auto-download, src/transforms.py:255-268)
    download: bool = False


@_register
@dataclass
class ChunkConfig:
    max_length: float = 3.0  # seconds
    lengths: List[float] = field(default_factory=lambda: [1.5, 2.0, 3.0])


@_register
@dataclass
class SpeedConfig:
    min: float = 0.95
    max: float = 1.05
    # sox-style continuous rate ~ U(min, max) instead of the discrete
    # {min, 1.0, max} polyphase resampler (see data.loader.SpeedConfig)
    continuous: bool = False


@_register
@dataclass
class SpecaugmentConfig:
    freq_mask_ratio: float = 0.35
    freq_mask_num: int = 1
    time_mask_ratio: float = 0.15
    time_mask_num: int = 1


@_register
@dataclass
class NoiseConfig:
    """Device-side additive noise at a random SNR (enable via
    ``augmentation.enable: [..., "noise"]``; beyond the reference, which
    has no noise augmentation). Generator-synthesized white/pink noise; real
    recordings (the usual MUSAN mix) come in through ``source: files``."""

    snr_min: float = 5.0  # dB
    snr_max: float = 20.0
    color: str = "white"  # white | pink (synthetic source)
    # "synthetic": device-side generator noise inside the train step;
    # "files": host-side mixing of real recordings (MUSAN-style) from
    # corpora_path (auto-fetched from OpenSLR-17 when download=true)
    source: str = "synthetic"
    corpora_path: str = "./data/musan"
    download: bool = False


@_register
@dataclass
class AugmentationConfig:
    probability: float = 0.5
    enable: List[str] = field(default_factory=lambda: ["chunk"])
    rir: "RirConfig" = field(default_factory=RirConfig)
    chunk: "ChunkConfig" = field(default_factory=ChunkConfig)
    speed: "SpeedConfig" = field(default_factory=SpeedConfig)
    specaugment: "SpecaugmentConfig" = field(default_factory=SpecaugmentConfig)
    noise: "NoiseConfig" = field(default_factory=NoiseConfig)


@_register
@dataclass
class MeshConfig:
    """Data-parallel layout (the JAX package's device mesh; one rank a
    device in the port, :mod:`titanet_torch.parallel`). ``data_axis`` names
    the mesh axis (the ``axis_name`` of the ``shard_map`` BatchNorm rule).
    ``num_devices``: under a launcher's process group, None or its world
    size; without one, ``N > 1`` makes ``train`` start N local ranks that
    split each batch of ``training.batch_size`` rows (which N must divide;
    at most the visible cards), 1 trains in this process, and None means
    every visible card, as in the JAX package (one rank each on ``cuda``;
    one process on the CPU or a named card)."""

    data_axis: str = "data"
    num_devices: Optional[int] = None


@_register
@dataclass
class Config:
    dataset: "DatasetConfig" = field(default_factory=DatasetConfig)
    training: "TrainingConfig" = field(default_factory=TrainingConfig)
    figures: "FiguresConfig" = field(default_factory=FiguresConfig)
    validation: "ValidationConfig" = field(default_factory=ValidationConfig)
    test: "TestConfig" = field(default_factory=TestConfig)
    loss: "LossConfig" = field(default_factory=LossConfig)
    dumb: "DumbConfig" = field(default_factory=DumbConfig)
    titanet: "TitanetConfig" = field(default_factory=TitanetConfig)
    baseline: "BaselineConfig" = field(default_factory=BaselineConfig)
    ecapa: "EcapaConfig" = field(default_factory=EcapaConfig)
    xvector: "XvectorConfig" = field(default_factory=XvectorConfig)
    resnet: "ResnetConfig" = field(default_factory=ResnetConfig)
    conformer: "ConformerConfig" = field(default_factory=ConformerConfig)
    distill: "DistillConfig" = field(default_factory=DistillConfig)
    wandb: "WandbConfig" = field(default_factory=WandbConfig)
    generic: "GenericConfig" = field(default_factory=GenericConfig)
    audio: "AudioConfig" = field(default_factory=AudioConfig)
    augmentation: "AugmentationConfig" = field(default_factory=AugmentationConfig)
    mesh: "MeshConfig" = field(default_factory=MeshConfig)

    def validate(self) -> "Config":
        assert self.training.loss in ("ce", "sphere", "cos", "arc", "ge2e"), (
            f"Unknown loss {self.training.loss!r}"
        )
        assert self.titanet.model_size.lower() in ("s", "m", "l"), (
            f"Unsupported model size {self.titanet.model_size!r}"
        )
        assert self.training.dtype in ("float32", "bfloat16")
        assert self.audio.spectrogram.n_fft > 0
        assert 0.0 <= self.augmentation.probability <= 1.0
        n_enabled = sum(
            [self.dumb.enabled, self.baseline.enabled and not self.dumb.enabled]
        )
        del n_enabled  # model selection precedence mirrors reference train.py:87-121
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        return _build(cls, data).validate()

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        """Read a YAML file; a ``.json`` file (JSON is a subset of YAML) is
        read with the standard library, so it needs no PyYAML."""
        if path.lower().endswith(".json"):
            import json

            with open(path, "r") as f:
                return cls.from_dict(json.load(f) or {})
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"reading {path!r} needs PyYAML (pip install pyyaml); "
                "or build the Config in code: Config.from_dict({...})"
            ) from e
        with open(path, "r") as f:
            data = yaml.safe_load(f)
        return cls.from_dict(data or {})


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply ``{"a.b.c": value}`` dotted-path overrides to a Config."""
    data = cfg.to_dict()
    for dotted, value in overrides.items():
        node: Any = data
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node[p]
        if leaf not in node:
            raise ValueError(f"Unknown override key {dotted!r}")
        node[leaf] = value
    return Config.from_dict(data).validate()


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Load a config from YAML with optional ``{"a.b.c": value}`` overrides."""
    cfg = Config.from_yaml(path) if path else Config()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg.validate()
