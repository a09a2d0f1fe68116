"""Speaker-keyed dataset protocol and corpus backends (the port's own copy
of ``titanet_tpu/data/dataset.py``).

A :class:`SpeakerDataset` base with speaker<->id maps, deterministic
val/test splits, random-utterance sampling and all-pairs generation, plus
corpus backends for LibriSpeech, VCTK 0.92, VoxCeleb1/2 (read from local
directories) and a synthetic corpus for tests and benchmarks. Everything
here is numpy, as in the JAX package, so the same seed gives the same
waveforms and the same splits in both packages.

- datasets yield RAW WAVEFORMS; the mel frontend runs on the device
  (``titanet_torch.ops.frontend``),
- ``download=True`` fetches a missing corpus through
  :mod:`titanet_torch.data.acquire` (``source_url`` / ``dev_urls``
  overrides let tests serve local ``file://`` archives),
- verification pairs are returned as (indices, labels) for batched scoring
  (one matmul) rather than materialized O(N^2) example pairs.
"""

from __future__ import annotations

import itertools
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from titanet_torch.data.audio_io import read_audio


class SpeakerDataset:
    """Base dataset: integer-indexed utterances grouped by speaker
    (reference SpeakerDataset, src/datasets.py:116-294)."""

    def __init__(self):
        self.speakers_utterances: Dict = self.get_speakers_utterances()
        self.speakers: List = list(self.speakers_utterances.keys())
        self.speakers_to_id = {s: i for i, s in enumerate(self.speakers)}
        self.id_to_speakers = {i: s for i, s in enumerate(self.speakers)}

    # -- corpus interface ---------------------------------------------------
    def get_speakers_utterances(self) -> Dict:
        raise NotImplementedError

    def get_sample(self, idx: int) -> Tuple[np.ndarray, int, object]:
        """-> (waveform [C, T] float32, sample_rate, speaker)."""
        raise NotImplementedError

    def get_path(self, idx: int) -> str:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # -- shared logic (reference src/datasets.py:151-294) --------------------
    def get_num_speakers(self) -> int:
        return len(self.speakers)

    def get_sample_pairs(self, indices: Optional[Sequence[int]] = None):
        """Lazy (i, j, same_speaker) triples over the Cartesian product of
        utterances — the reference pair protocol (src/datasets.py:165-183:
        itertools.product incl. self-pairs and both orderings), minus its
        O(N^2) eager materialization. Batched scoring should prefer
        :func:`titanet_torch.train.metrics.all_pairs_scores_labels`."""
        import itertools

        indices = list(indices) if indices is not None else list(range(len(self)))
        spk = {i: self[i]["speaker"] for i in indices}
        for i1, i2 in itertools.product(indices, repeat=2):
            yield i1, i2, spk[i1] == spk[i2]

    def get_random_utterances(
        self, n_speakers: int = 5, n_utterances_per_speaker: int = 20, seed=None
    ):
        rng = np.random.default_rng(seed)
        utterances, speakers = [], []
        chosen = rng.choice(self.speakers, size=n_speakers)
        for speaker in chosen:
            speaker_utterances = self.speakers_utterances[speaker]
            utterances += list(
                rng.choice(speaker_utterances, size=n_utterances_per_speaker)
            )
            speakers += [speaker] * n_utterances_per_speaker
        return utterances, speakers

    def _test_split_speaker_order(self) -> List[str]:
        """Speaker priority order used to select the held-out test
        speakers in :meth:`get_splits`. Default: corpus order (matches
        the reference, src/datasets.py:191-229). Unions override this to
        spread test speakers across member corpora."""
        return list(self.speakers)

    def get_splits(
        self,
        val: bool = True,
        val_utterances_per_speaker: int = 10,
        test: bool = True,
        test_speakers: int = 10,
        test_utterances_per_speaker: int = 10,
        exclusive_test_speakers: bool = False,
    ):
        """Deterministic per-speaker train/val/test split
        (reference src/datasets.py:191-229).

        Reference semantics (the default): a test speaker's utterances
        BEYOND ``val + test`` per speaker remain in the TRAIN split
        (reference src/datasets.py:204-217) — so whenever a corpus has
        more utterances per speaker than ``val_ups + test_ups``, test
        speakers are *seen* during training (closed-set verification).
        ``exclusive_test_speakers=True`` is the open-set extension the
        reference lacks: test speakers contribute ONLY their test
        utterances — nothing to train or val — so verification measures
        generalization to unseen identities.
        """
        test_spk = set(self._test_split_speaker_order()[:test_speakers])
        train_utt, val_utt, test_utt = [], [], []
        for s in self.speakers:
            start = 0
            is_test_spk = test and s in test_spk
            if val and not (is_test_spk and exclusive_test_speakers):
                val_utt += self.speakers_utterances[s][:val_utterances_per_speaker]
                start += val_utterances_per_speaker
            elif val:
                # exclusive test speaker: skip the val slice but keep the
                # utterance offsets identical so the TEST split is the
                # same set of utterances in both modes.
                start += val_utterances_per_speaker
            if is_test_spk:
                test_utt += self.speakers_utterances[s][
                    val_utterances_per_speaker : val_utterances_per_speaker
                    + test_utterances_per_speaker
                ]
                start += test_utterances_per_speaker
                if exclusive_test_speakers:
                    continue  # nothing from this speaker reaches train
            train_utt += self.speakers_utterances[s][start:]
        assert (not val or len(val_utt) > 0) and (not test or len(test_utt) > 0), (
            "No validation or test utterances"
        )
        assert not set(train_utt) & set(val_utt) and not set(val_utt) & set(test_utt), (
            "Splits are not disjoint"
        )
        return train_utt, val_utt, test_utt

    def get_durations(self) -> Dict[int, float]:
        durations = {}
        for idx in range(len(self)):
            wav, sr, _ = self.get_sample(idx)
            durations[idx] = wav.shape[-1] / sr
        return durations

    def get_durations_per_speaker(self, hours: bool = True) -> Dict:
        durations = self.get_durations()
        div = 3600 if hours else 1
        return {
            speaker: sum(durations[i] for i in utts) / div
            for speaker, utts in self.speakers_utterances.items()
        }

    def info(self, hours: bool = True) -> Dict:
        ups = [len(u) for u in self.speakers_utterances.values()]
        dps = list(self.get_durations_per_speaker(hours=hours).values())
        return {
            "num_utterances": len(self),
            "num_speakers": self.get_num_speakers(),
            "total_duration": round(sum(dps), 2),
            "utterances_per_speaker_mean": round(float(np.mean(ups)), 2),
            "utterances_per_speaker_std": round(float(np.std(ups)), 2),
            "durations_per_speaker_mean": round(float(np.mean(dps)), 2),
            "durations_per_speaker_std": round(float(np.std(dps)), 2),
        }

    def __getitem__(self, idx: int) -> Dict:
        waveform, sample_rate, speaker = self.get_sample(idx)
        return {
            "waveform": waveform,
            "sample_rate": sample_rate,
            "speaker": speaker,
            "speaker_id": self.speakers_to_id[speaker],
        }


class Subset(SpeakerDataset):
    """Index-remapped view of a dataset (torch.utils.data.Subset role,
    reference usage src/datasets.py:231-238) that honors the FULL
    SpeakerDataset protocol: ``speakers_utterances`` is re-derived in view-
    local indices (so ``get_splits``/``get_random_utterances``/``info``/
    ``get_durations_per_speaker`` work on views), while the speaker<->id
    maps stay the PARENT's so class labels are consistent across splits."""

    def __init__(self, parent: SpeakerDataset, indices: Sequence[int]):
        self.parent = parent
        self.indices = list(indices)
        positions = defaultdict(list)  # parent index -> view positions
        for local, real in enumerate(self.indices):
            positions[real].append(local)
        self.speakers_utterances = {}
        for spk, utts in parent.speakers_utterances.items():
            local_utts = [loc for real in utts for loc in positions.get(real, ())]
            if local_utts:
                self.speakers_utterances[spk] = local_utts
        self.speakers = list(self.speakers_utterances.keys())
        self.speakers_to_id = parent.speakers_to_id
        self.id_to_speakers = parent.id_to_speakers

    def __len__(self):
        return len(self.indices)

    def get_sample(self, idx):
        return self.parent.get_sample(self.indices[idx])

    def get_path(self, idx):
        return self.parent.get_path(self.indices[idx])

    def __getitem__(self, idx):
        return self.parent[self.indices[idx]]


class ConcatSpeakerDataset(SpeakerDataset):
    """Union of several corpora as ONE speaker dataset (beyond the
    reference, which trains on exactly one corpus — src/train.py:49-57;
    combining corpora is the standard way to scale speaker coverage).

    Speakers are namespaced per source (``"<name>/<speaker>"``) so label
    spaces from different corpora never collide; utterance indices
    concatenate in dataset order. The FULL :class:`SpeakerDataset`
    protocol (splits, pairs, random sampling, durations, info) works on
    the union, so the training/eval stack is unchanged. Build via
    ``get_datasets(name="librispeech+vctk")``.
    """

    def __init__(self, datasets: Sequence[SpeakerDataset],
                 names: Optional[Sequence[str]] = None):
        if not datasets:
            raise ValueError("ConcatSpeakerDataset needs >= 1 dataset")
        self.datasets = list(datasets)
        names = (list(names) if names is not None
                 else [f"d{i}" for i in range(len(self.datasets))])
        if len(names) != len(self.datasets):
            raise ValueError(
                f"{len(names)} names for {len(self.datasets)} datasets"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate corpus names: {names!r}")
        self.names = names
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        super().__init__()

    def get_speakers_utterances(self):
        out = {}
        for name, ds, off in zip(self.names, self.datasets,
                                 self._offsets[:-1]):
            for spk, utts in ds.speakers_utterances.items():
                out[f"{name}/{spk}"] = [int(u) + int(off) for u in utts]
        return out

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, idx: int) -> Tuple[int, int]:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return k, int(idx - self._offsets[k])

    def get_sample(self, idx):
        k, j = self._locate(idx)
        waveform, sample_rate, speaker = self.datasets[k].get_sample(j)
        return waveform, sample_rate, f"{self.names[k]}/{speaker}"

    def get_path(self, idx):
        k, j = self._locate(idx)
        return self.datasets[k].get_path(j)

    def _test_split_speaker_order(self):
        """Round-robin over member corpora so the held-out test split
        samples every source, not just the first-listed one (the base
        corpus-order rule would drain dataset 0 before touching others)."""
        per_source = [
            [f"{name}/{spk}" for spk in ds.speakers]
            for name, ds in zip(self.names, self.datasets)
        ]
        order: List[str] = []
        for layer in itertools.zip_longest(*per_source):
            order += [s for s in layer if s is not None]
        return order


class LibriSpeechDataset(SpeakerDataset):
    """LibriSpeech layout: ``root/LibriSpeech/<url>/<speaker>/<chapter>/
    <speaker>-<chapter>-<utt>.flac`` (reference src/datasets.py:297-332,
    torchaudio LIBRISPEECH conventions)."""

    def __init__(
        self,
        root: str,
        url: str = "train-clean-100",
        download: bool = False,
        source_url: Optional[str] = None,
    ):
        self._path = os.path.join(root, "LibriSpeech", url)
        if not os.path.isdir(self._path):
            if download:
                # reference auto-download semantics (src/datasets.py:303-306)
                from titanet_torch.data.acquire import fetch_librispeech

                fetch_librispeech(root, subset=url, source_url=source_url)
            else:
                raise FileNotFoundError(
                    f"LibriSpeech not found at {self._path}. Pass "
                    "download=True to fetch it, or place the extracted "
                    "corpus there."
                )
        self._walker = sorted(
            str(p) for p in Path(self._path).rglob("*.flac")
        )
        super().__init__()

    def __len__(self):
        return len(self._walker)

    def get_speakers_utterances(self):
        speakers_utterances = defaultdict(list)
        for i, path in enumerate(self._walker):
            speaker_id = int(Path(path).name.split("-")[0])
            speakers_utterances[speaker_id].append(i)
        return speakers_utterances

    def get_path(self, idx):
        return self._walker[idx]

    def get_sample(self, idx):
        wav, sr = read_audio(self._walker[idx])
        speaker = int(Path(self._walker[idx]).name.split("-")[0])
        return wav, sr, speaker


class VCTKDataset(SpeakerDataset):
    """VCTK 0.92 layout: ``root/wav48_silence_trimmed/<speaker>/
    <speaker>_<utt>_<mic>.flac`` (reference src/datasets.py:335-365)."""

    def __init__(
        self,
        root: str,
        mic_id: str = "mic2",
        download: bool = False,
        source_url: Optional[str] = None,
    ):
        self._audio_dir = os.path.join(root, "wav48_silence_trimmed")
        if not os.path.isdir(self._audio_dir):
            if download:
                # reference auto-download semantics (src/datasets.py:340-343)
                from titanet_torch.data.acquire import fetch_vctk

                fetch_vctk(root, source_url=source_url)
            else:
                raise FileNotFoundError(
                    f"VCTK not found at {self._audio_dir}. Pass download=True "
                    "to fetch it."
                )
        self._mic_id = mic_id
        self._walker = sorted(
            str(p)
            for p in Path(self._audio_dir).rglob(f"*_{mic_id}.flac")
        )
        super().__init__()

    def __len__(self):
        return len(self._walker)

    def get_speakers_utterances(self):
        speakers_utterances = defaultdict(list)
        for i, path in enumerate(self._walker):
            speakers_utterances[Path(path).name.split("_")[0]].append(i)
        return speakers_utterances

    def get_path(self, idx):
        return self._walker[idx]

    def get_sample(self, idx):
        wav, sr = read_audio(self._walker[idx])
        return wav, sr, Path(self._walker[idx]).name.split("_")[0]


class VoxCelebDataset(SpeakerDataset):
    """VoxCeleb1/2 layout: ``root/wav/<speaker>/<video>/<utt>.wav``
    (reference src/datasets.py:368-399, 568-597)."""

    def __init__(
        self, root: str, download: bool = False, version: int = 2, **acquire_kwargs
    ):
        self._path = os.path.join(root, "wav")
        if not os.path.isdir(self._path):
            if download:
                # version routes the fetcher: VoxCeleb1 = multi-part wav
                # archives (reference delegates to torchaudio's downloader,
                # src/datasets.py:373-377); VoxCeleb2 = multi-part authed
                # m4a download + zip reassembly + m4a->wav transcode
                # (src/datasets.py:479-541). Pass transcode=/dev_urls=/
                # credentials via acquire_kwargs.
                from titanet_torch.data import acquire

                if version == 1:
                    acquire.fetch_voxceleb1(root, **acquire_kwargs)
                elif version == 2:
                    acquire.fetch_voxceleb2(root, **acquire_kwargs)
                else:
                    raise ValueError(
                        f"VoxCeleb version must be 1 or 2, got {version!r}"
                    )
            else:
                raise FileNotFoundError(
                    f"VoxCeleb not found at {self._path}. Pass download=True "
                    "(with version=1 or 2) or place .wav files under root/wav/."
                )
        self._walker = sorted(str(p) for p in Path(self._path).rglob("*.wav"))
        super().__init__()

    def __len__(self):
        return len(self._walker)

    def get_speakers_utterances(self):
        speakers_utterances = defaultdict(list)
        for i, path in enumerate(self._walker):
            speakers_utterances[Path(path).parts[-3]].append(i)
        return speakers_utterances

    def get_path(self, idx):
        return self._walker[idx]

    def get_sample(self, idx):
        wav, sr = read_audio(self._walker[idx])
        return wav, sr, Path(self._walker[idx]).parts[-3]


_SHARED_SYNTH_CACHES: Dict[tuple, Dict[int, Tuple]] = {}


class SyntheticSpeakerDataset(SpeakerDataset):
    """Procedural speaker corpus for tests/benchmarks (no disk IO).

    Each speaker has fixed formant frequencies; utterances are harmonic
    stacks with per-utterance pitch/noise — linearly separable enough for a
    smoke-test model to overfit (the role DumbConvNet + tiny split played in
    the reference, src/train.py:59-60).

    Difficulty knobs (all default to the easy round-1 behavior) make the
    corpus DISCRIMINATIVE — a benchmark where a smoke-scale run lands at a
    nonzero, regression-sensitive EER rather than a 0.0 ceiling:

    - ``formant_jitter``: when set, speaker formants are small per-speaker
      offsets (std ``formant_jitter`` Hz) around SHARED centers
      (500/1500/2500 Hz) instead of independent uniform(300, 3200) draws —
      speakers become genuinely confusable,
    - ``f0_range``: per-speaker pitch range; narrow it to overlap speakers,
    - ``pitch_jitter``: per-utterance pitch wobble (fraction of f0),
    - ``noise_level``: additive white noise amplitude,
    - ``reverb_prob``: probability of convolving a random exponentially-
      decaying synthetic RIR (per-utterance room).
    """

    def __init__(
        self,
        n_speakers: int = 8,
        utterances_per_speaker: int = 12,
        sample_rate: int = 16000,
        min_seconds: float = 1.2,
        max_seconds: float = 3.5,
        seed: int = 0,
        formant_jitter: Optional[float] = None,
        f0_range: Tuple[float, float] = (90.0, 280.0),
        pitch_jitter: float = 0.05,
        noise_level: float = 0.01,
        reverb_prob: float = 0.0,
        cache: bool = True,
    ):
        self.n = n_speakers * utterances_per_speaker
        self.n_speakers_ = n_speakers
        self.ups = utterances_per_speaker
        self.sample_rate = sample_rate
        self.min_seconds, self.max_seconds = min_seconds, max_seconds
        self.seed = seed
        self.pitch_jitter = pitch_jitter
        self.noise_level = noise_level
        self.reverb_prob = reverb_prob
        # synthesis is deterministic per (seed, idx): cache waveforms so
        # epochs don't re-synthesize (augmentation happens in the loader).
        # The cache dict is SHARED process-wide between instances with
        # identical constructor params (benchmark sweeps build the same
        # corpus once per run; at 256 spk x 100 utt synthesis costs ~5 min)
        if cache:
            key = (
                n_speakers, utterances_per_speaker, sample_rate,
                float(min_seconds), float(max_seconds), seed,
                None if formant_jitter is None else float(formant_jitter),
                (float(f0_range[0]), float(f0_range[1])),
                float(pitch_jitter), float(noise_level), float(reverb_prob),
            )
            self._cache: Optional[Dict[int, Tuple]] = (
                _SHARED_SYNTH_CACHES.setdefault(key, {})
            )
            # content-identity key (device_corpus cross-run reuse)
            self._synth_cache_key = key
        else:
            self._cache = None
        rng = np.random.default_rng(seed)
        self._f0 = rng.uniform(f0_range[0], f0_range[1], n_speakers)
        if formant_jitter is None:
            self._formants = rng.uniform(300, 3200, (n_speakers, 3))
        else:
            centers = np.array([500.0, 1500.0, 2500.0])
            self._formants = centers[None, :] + rng.normal(
                0.0, formant_jitter, (n_speakers, 3)
            )
        super().__init__()

    def __len__(self):
        return self.n

    def get_speakers_utterances(self):
        return {
            s: list(range(s * self.ups, (s + 1) * self.ups))
            for s in range(self.n_speakers_)
        }

    def get_path(self, idx):
        return f"synthetic://{idx}"

    def get_sample(self, idx):
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        out = self._synthesize(idx)
        if self._cache is not None:
            self._cache[idx] = out
        return out

    def _synthesize(self, idx):
        speaker = idx // self.ups
        rng = np.random.default_rng(self.seed * 100003 + idx)
        seconds = rng.uniform(self.min_seconds, self.max_seconds)
        t = np.arange(int(seconds * self.sample_rate)) / self.sample_rate
        jit = self.pitch_jitter
        f0 = self._f0[speaker] * rng.uniform(1.0 - jit, 1.0 + jit)
        x = np.zeros_like(t, np.float32)
        for k in range(1, 9):
            weight = sum(
                np.exp(-0.5 * ((k * f0 - fm) / 400.0) ** 2)
                for fm in self._formants[speaker]
            )
            x += (weight / k).astype(np.float32) * np.sin(
                2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)
            ).astype(np.float32)
        if self.reverb_prob > 0 and rng.random() < self.reverb_prob:
            # random room: exponentially decaying noise RIR, ~0.15 s
            rir_len = int(0.15 * self.sample_rate)
            rir = rng.standard_normal(rir_len) * np.exp(
                -np.arange(rir_len) / (0.03 * self.sample_rate)
            )
            rir[0] = 1.0
            rir = rir / np.linalg.norm(rir)
            n = 1
            while n < len(x) + rir_len - 1:
                n *= 2
            x = np.fft.irfft(
                np.fft.rfft(x, n) * np.fft.rfft(rir, n), n
            )[: len(t)].astype(np.float32)
        x += rng.standard_normal(len(t)).astype(np.float32) * self.noise_level
        x = 0.3 * x / max(np.abs(x).max(), 1e-6)
        return x[None, :].astype(np.float32), self.sample_rate, speaker


DATASETS = {
    "librispeech": LibriSpeechDataset,
    "vctk": VCTKDataset,
    "voxceleb1": VoxCelebDataset,
    "voxceleb2": VoxCelebDataset,
    "synthetic": SyntheticSpeakerDataset,
}


def get_datasets(
    dataset_root: str,
    name: str = "librispeech",
    val: bool = True,
    val_utterances_per_speaker: int = 10,
    test: bool = True,
    test_speakers: int = 10,
    test_utterances_per_speaker: int = 10,
    exclusive_test_speakers: bool = False,
    **kwargs,
):
    """Build (train, val, test, n_speakers) like reference get_datasets
    (src/datasets.py:76-113). ``name`` may be a ``+``-joined union
    ("librispeech+vctk") — see :class:`ConcatSpeakerDataset`; kwargs are
    filtered per backend constructor by signature."""
    if "+" in name:
        import inspect

        subs = [s.strip() for s in name.split("+") if s.strip()]
        if len(subs) < 2 or len(set(subs)) != len(subs):
            raise ValueError(
                f"union dataset name must join >=2 distinct corpora, "
                f"got {name!r}"
            )
        parts = []
        for sub in subs:
            if sub not in DATASETS:
                raise KeyError(f"unknown corpus {sub!r} in {name!r}")
            cls = DATASETS[sub]
            params = inspect.signature(cls.__init__).parameters
            sub_kwargs = {
                k: v for k, v in kwargs.items()
                if k in params
                and params[k].kind is not inspect.Parameter.VAR_KEYWORD
            }
            if sub == "voxceleb1":
                sub_kwargs.setdefault("version", 1)
            if sub == "synthetic":
                parts.append(cls(**sub_kwargs))
            else:
                parts.append(cls(dataset_root, **sub_kwargs))
        full = ConcatSpeakerDataset(parts, names=subs)
    elif name == "synthetic":
        full = SyntheticSpeakerDataset(**kwargs)
    else:
        if name == "voxceleb1":
            # Same name->version defaulting as the union branch above, so
            # "voxceleb1" routes acquisition identically either way.
            kwargs.setdefault("version", 1)
        full = DATASETS[name](dataset_root, **kwargs)
    train_utt, val_utt, test_utt = full.get_splits(
        val=val,
        val_utterances_per_speaker=val_utterances_per_speaker,
        test=test,
        test_speakers=test_speakers,
        test_utterances_per_speaker=test_utterances_per_speaker,
        exclusive_test_speakers=exclusive_test_speakers,
    )
    return (
        Subset(full, train_utt),
        Subset(full, val_utt),
        Subset(full, test_utt),
        full.get_num_speakers(),
    )
