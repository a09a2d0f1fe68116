"""Host-side batching and staging on the device (port of
``titanet_tpu/data/loader.py``).

- batches carry RAW waveforms padded to a small set of BUCKET lengths; the
  mel frontend runs on the device,
- RandomChunk, speed perturbation, reverb and noise mixing run on the host
  as part of batching (reference src/transforms.py),
- a background thread builds the next batches while the device computes,
  and decode-worker threads build a batch's examples in parallel,
- deterministic: each epoch's shuffle and augmentation draws derive from
  ``(seed, epoch)`` through numpy, exactly as in the JAX package, so the
  same seed and epoch give the same batches, bit for bit,
- :func:`device_prefetch` stages batches on the card from pinned host
  memory on a side CUDA stream,
- device-resident mode (:meth:`DataLoader.attach_device_corpus`,
  ``generic.device_corpus``): the loader yields
  :class:`~titanet_torch.data.device_corpus.DeviceBatch` descriptors with
  the same membership, crops and buckets, and the windows are gathered on
  the card from one int16 corpus tensor.

``shard_id``/``num_shards`` deal batches as the JAX loader does; the
port's trainer runs one process (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from titanet_torch.data.dataset import SpeakerDataset


@dataclass
class Batch:
    """One host batch (numpy). ``waveform [B, T]`` mono float32, or int16
    PCM when the loader's ``transport_dtype="int16"`` (dequantized on
    the device by the train and eval steps)."""

    waveform: np.ndarray
    lengths: np.ndarray  # int32 [B] valid samples per row
    speaker_ids: np.ndarray  # int32 [B]

    def __len__(self):
        return self.waveform.shape[0]


@dataclass
class ChunkConfig:
    """Reference RandomChunk semantics (src/transforms.py:206-233)."""

    max_length: float = 3.0
    lengths: Sequence[float] = field(default_factory=lambda: (1.5, 2.0, 3.0))
    enabled: bool = True


@dataclass
class SpeedConfig:
    """Host-side speed perturbation (reference SpeedPerturbation via sox,
    src/transforms.py:78-108).

    Two modes:
    - discrete (default): rate drawn from ``rates``; exact polyphase sinc
      resampling with kernels cached per rate (torchaudio
      ``SpeedPerturbation`` convention),
    - ``continuous=True``: rate ~ U(min(rates), max(rates)) like sox's
      continuous ``speed`` effect, via linear-interpolation resampling
      (arbitrary ratios make polyphase kernel caching impossible; linear
      interp's slight HF rolloff is augmentation-grade, not a parity
      surface)."""

    rates: Sequence[float] = (0.95, 1.0, 1.05)
    probability: float = 1.0
    enabled: bool = False
    continuous: bool = False


@dataclass
class NoiseMixConfig:
    """Host-side real-noise mixing at a random SNR (MUSAN-style; the
    standard speaker-augmentation recipe — the reference has none). A
    random file from ``paths`` is looped/cropped to the utterance length
    and added at ``SNR ~ U(snr_min, snr_max)`` dB of the utterance's own
    power. The device-side synthetic variant lives in
    :func:`titanet_torch.ops.augment.add_noise`
    (``augmentation.noise.source: synthetic``)."""

    paths: Sequence[str] = ()
    probability: float = 1.0
    snr_min: float = 5.0
    snr_max: float = 20.0
    enabled: bool = False


@dataclass
class ReverbConfig:
    """Host-side convolution reverb (reference Reverb, src/transforms.py:
    236-298): random RIR from a corpus dir, power-normalized, convolved."""

    rir_paths: Sequence[str] = ()
    probability: float = 1.0
    enabled: bool = False


def default_buckets(sample_rate: int, chunk: ChunkConfig, max_seconds: float = 20.0):
    """Bucket boundaries in samples: the chunk lengths plus power-of-two-ish
    steps up to ``max_seconds`` for unchunked (eval) utterances."""
    buckets = sorted({int(l * sample_rate) for l in chunk.lengths})
    top = buckets[-1] if buckets else sample_rate
    while top < max_seconds * sample_rate:
        top *= 2
        buckets.append(int(top))
    return buckets


class DataLoader:
    """Seeded, bucketed, chunking loader over a :class:`SpeakerDataset`."""

    def __init__(
        self,
        dataset: SpeakerDataset,
        batch_size: int = 8,
        shuffle: bool = True,
        drop_last: bool = True,
        chunk: Optional[ChunkConfig] = None,
        speed: Optional["SpeedConfig"] = None,
        reverb: Optional["ReverbConfig"] = None,
        noise: Optional["NoiseMixConfig"] = None,
        sample_rate: int = 16000,
        seed: int = 42,
        buckets: Optional[List[int]] = None,
        prefetch: int = 2,
        num_workers: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        balanced: Optional[tuple] = None,  # (n_speakers, m_utterances) per batch
        transport_dtype: str = "float32",  # or "int16": PCM wire format,
        # halves host->device transfer (dequantized on device; audio sources
        # are 16-bit PCM, so int16 is the source's own precision)
        cache_waveforms: bool = False,  # memoize decoded+resampled audio
        cache_budget_mb: int = 2048,  # int16 PCM bytes kept in memory
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.chunk = chunk or ChunkConfig(enabled=False)
        self.speed = speed or SpeedConfig(enabled=False)
        self.reverb = reverb or ReverbConfig(enabled=False)
        self.noise = noise or NoiseMixConfig(enabled=False)
        self.sample_rate = sample_rate
        self.seed = seed
        self.buckets = buckets or default_buckets(sample_rate, self.chunk)
        self.prefetch = prefetch
        # Decode-worker threads (reference used DataLoader worker processes,
        # src/datasets.py:38). Our FLAC decoder is a C call (GIL released),
        # so threads give real parallelism on multi-core hosts.
        self.num_workers = num_workers
        # Multi-host data sharding (SURVEY.md §5 "per-host loaders"): each
        # host sees a disjoint interleaved slice of every epoch's order.
        assert 0 <= shard_id < num_shards
        self.shard_id = shard_id
        self.num_shards = num_shards
        # Speaker-balanced batching for contrastive losses (GE2E expects
        # N speakers x M utterances per batch — Wan et al., arXiv:1710.10467;
        # the reference had no sampler and fed GE2E random batches).
        self.balanced = balanced
        if balanced is not None:
            assert batch_size == balanced[0] * balanced[1], (
                "batch_size must equal n_speakers * m_utterances"
            )
        assert transport_dtype in ("float32", "int16")
        self.transport_dtype = transport_dtype
        # Decoded-waveform cache: the reference re-decoded and re-ran the
        # whole transform chain per example per EPOCH (src/datasets.py:283-294
        # — SURVEY.md §3.2 names it a hot loop). Decode dominates this host
        # pipeline (bench_loader.py), so epochs >= 2 skip it entirely: the
        # post-decode/post-resample waveform is memoized as int16 PCM (the
        # sources' own bit depth) up to ``cache_budget_mb``; random
        # augmentation stays per-epoch downstream of the cache.
        self.cache_waveforms = cache_waveforms
        self.cache_budget_mb = cache_budget_mb
        self._wave_cache: dict = {}
        self._cache_bytes = 0
        self.epoch = 0
        self._rir_cache: dict = {}
        self._noise_cache: dict = {}
        # Device-resident corpus mode (data/device_corpus.py): batches
        # become descriptors; waveform windows gather on the device.
        self._device_corpus = None
        self._device_base_index = None
        self._device_owned_local = None

    def __len__(self):
        """Steps per epoch FOR THIS SHARD (drives the cosine schedule
        length). With ``num_shards > 1``, whole batches are dealt
        round-robin and every shard gets the same count (remainder batches
        dropped) so multi-host collectives stay in lockstep. Static
        device-corpus sharding composes batches within each shard's
        utterance slice, equalized to ``(N // P) // B`` steps."""
        n = len(self.dataset)
        n_full = n // self.batch_size
        if self._device_owned_local is not None:
            return (n // self.num_shards) // self.batch_size
        if self.num_shards > 1:
            return n_full // self.num_shards
        if self.drop_last or self.balanced is not None:
            return n_full
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def attach_device_corpus(self, corpus):
        """Switch this loader to device-resident mode: yield
        :class:`titanet_torch.data.device_corpus.DeviceBatch` descriptors
        instead of host waveform arrays. Requires every waveform-
        transforming HOST augmentation to be disabled (chunking is a
        crop, expressible as a device window; SpecAugment and noise run in
        the train step).

        With ``num_shards > 1`` this becomes STATIC utterance sharding:
        local index ``i`` belongs to shard ``i % num_shards`` and each
        shard composes its batches from its own slice only (so its corpus
        shard, built from exactly those root indices, is all the device
        memory it needs). Step counts stay equalized across shards
        (``(N // P) // B`` each).
        """
        if self.speed.enabled or self.reverb.enabled or self.noise.enabled:
            raise ValueError(
                "device-resident corpus mode is incompatible with host-side "
                "speed/reverb/noise augmentation (they transform waveforms "
                "on the host); disable them or use the host loader"
            )
        from titanet_torch.data.device_corpus import resolve_base

        _root, base_index = resolve_base(self.dataset)
        self._device_corpus = corpus
        self._device_base_index = base_index
        self._device_owned_local = None
        if self.num_shards > 1:
            local = np.arange(len(self.dataset), dtype=np.int64)
            owned = local[local % self.num_shards == self.shard_id]
            missing = [int(i) for i in owned
                       if corpus.offsets[int(base_index[i])] < 0]
            if missing:
                raise ValueError(
                    f"device corpus shard is missing {len(missing)} owned "
                    f"utterances (e.g. local idx {missing[:3]}); build it "
                    "with root_indices = this loader's device_shard_root_"
                    "indices()"
                )
            self._device_owned_local = owned

    def device_shard_root_indices(self) -> np.ndarray:
        """ROOT-dataset indices this loader's static device-corpus shard
        must contain (see :meth:`attach_device_corpus`): the local indices
        owned by ``shard_id`` under ``i % num_shards``, mapped through any
        Subset views. Single-shard loaders own everything."""
        from titanet_torch.data.device_corpus import resolve_base

        _root, base_index = resolve_base(self.dataset)
        local = np.arange(len(self.dataset), dtype=np.int64)
        if self.num_shards > 1:
            local = local[local % self.num_shards == self.shard_id]
        return np.asarray(base_index[local], np.int64)

    def _chunk_plan(self, n_samples: int, rng: np.random.Generator):
        """RandomChunk draw (reference src/transforms.py:216-233): returns
        ``(start, length)`` within an ``n_samples`` utterance. The SINGLE
        source of truth for the chunk RNG stream: the host decode path and
        the device-descriptor path stay draw-for-draw identical."""
        if self.chunk.enabled and n_samples / self.sample_rate > self.chunk.max_length:
            length = int(rng.choice(self.chunk.lengths) * self.sample_rate)
            length = min(length, n_samples)
            start = int(rng.integers(0, n_samples - length + 1))
            return start, length
        return 0, n_samples

    def _plan_one(self, idx: int, rng: np.random.Generator):
        """Device-mode mirror of :meth:`_load_one`: same per-example RNG
        stream, but only the crop coordinates are computed (no audio)."""
        base = int(self._device_base_index[idx])
        n = int(self._device_corpus.lengths[base])
        start, length = self._chunk_plan(n, rng)
        return (
            int(self._device_corpus.offsets[base]) + start,
            length,
            int(self._device_corpus.speaker_ids[base]),
        )

    def _device_batches(self, order: np.ndarray, batch_ids, *stream):
        """Descriptor batches ``batch_ids`` of ``order``; example ``j`` of
        batch ``b`` draws from ``(seed, epoch, *stream, b * B + j)``, the
        stream :meth:`_load_one` gets at that position."""
        for b in batch_ids:
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            plans = [
                self._plan_one(int(i), np.random.default_rng(
                    (self.seed, self.epoch, *stream, b * self.batch_size + j)))
                for j, i in enumerate(idxs)
            ]
            yield self._make_device_batch(plans)

    def _make_device_batch(self, plans):
        from titanet_torch.data.device_corpus import DeviceBatch

        lengths = np.asarray([p[1] for p in plans], np.int64)
        t = self._bucket_for(int(lengths.max()))
        return DeviceBatch(
            corpus=self._device_corpus,
            starts=np.asarray([p[0] for p in plans], np.int64),
            lengths=np.minimum(lengths, t).astype(np.int32),
            speaker_ids=np.asarray([p[2] for p in plans], np.int32),
            t=t,
        )

    # -- internals ----------------------------------------------------------
    def _decoded(self, idx: int):
        """``(waveform float32 [T] at the pipeline rate, speaker_id)``.

        With ``cache_waveforms``, serves from / inserts into the int16 PCM
        cache. Values are quantized on the MISS path too, so every epoch
        sees bit-identical base audio whether or not the item fit the
        budget (thread-safe under the decode pool: dict ops are atomic,
        and a racy double-insert is idempotent).
        """
        if self.cache_waveforms:
            hit = self._wave_cache.get(idx)
            if hit is not None:
                q, speaker_id = hit
                return q.astype(np.float32) / 32768.0, speaker_id
        ex = self.dataset[idx]
        wav = np.asarray(ex["waveform"], np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
        sr = ex["sample_rate"]
        if sr != self.sample_rate:
            wav = _resample_host(wav, sr, self.sample_rate)
        if not self.cache_waveforms:
            return wav, ex["speaker_id"]
        q = np.clip(wav * 32768.0, -32768.0, 32767.0).astype(np.int16)
        if self._cache_bytes + q.nbytes <= self.cache_budget_mb * (1 << 20):
            self._wave_cache[idx] = (q, ex["speaker_id"])
            self._cache_bytes += q.nbytes
        return q.astype(np.float32) / 32768.0, ex["speaker_id"]

    def _load_one(self, idx: int, rng: np.random.Generator):
        wav, speaker_id = self._decoded(idx)
        if self.speed.enabled and rng.random() < self.speed.probability:
            if self.speed.continuous:
                rate = float(
                    rng.uniform(min(self.speed.rates), max(self.speed.rates))
                )
                if abs(rate - 1.0) > 1e-6:
                    pos = np.arange(0, len(wav) - 1, rate)
                    wav = np.interp(pos, np.arange(len(wav)), wav).astype(
                        np.float32
                    )
            else:
                rate = float(rng.choice(self.speed.rates))
                if rate != 1.0:
                    wav = _resample_host(
                        wav, self.sample_rate, int(round(self.sample_rate / rate))
                    )
        if self.reverb.enabled and self.reverb.rir_paths and (
            rng.random() < self.reverb.probability
        ):
            wav = self._apply_reverb(wav, rng)
        if self.noise.enabled and self.noise.paths and (
            rng.random() < self.noise.probability
        ):
            wav = self._apply_noise(wav, rng)
        start, length = self._chunk_plan(len(wav), rng)
        wav = wav[start : start + length]
        return wav, speaker_id

    def _apply_reverb(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Reference reverb semantics (src/transforms.py:276-296): random
        RIR, resampled to the pipeline rate, power-normalized, causal
        convolution truncated to input length (FFT-based)."""
        path = str(rng.choice(list(self.reverb.rir_paths)))
        rir = self._rir_cache.get(path)
        if rir is None:
            from titanet_torch.data.audio_io import read_audio

            r, r_sr = read_audio(path)
            r = r.mean(axis=0) if r.ndim == 2 else r
            if r_sr != self.sample_rate:
                r = _resample_host(r, r_sr, self.sample_rate)
            r = r / max(np.linalg.norm(r), 1e-12)
            self._rir_cache[path] = r
            rir = r
        t = len(wav)
        n = 1
        while n < t + len(rir) - 1:
            n *= 2
        out = np.fft.irfft(np.fft.rfft(wav, n) * np.fft.rfft(rir, n), n)[:t]
        return out.astype(np.float32)

    def _apply_noise(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Mix a random noise file at ``SNR ~ U(snr_min, snr_max)`` dB:
        loop/crop the noise to the utterance length, scale its measured
        power against the utterance's, add."""
        path = str(rng.choice(list(self.noise.paths)))
        noise = self._noise_cache.get(path)
        if noise is None:
            from titanet_torch.data.audio_io import read_audio

            n, n_sr = read_audio(path)
            n = n.mean(axis=0) if n.ndim == 2 else n
            if n_sr != self.sample_rate:
                n = _resample_host(n, n_sr, self.sample_rate)
            noise = n.astype(np.float32)
            self._noise_cache[path] = noise
        t = len(wav)
        if len(noise) < t:
            noise = np.tile(noise, -(-t // len(noise)))
        start = int(rng.integers(0, len(noise) - t + 1))
        seg = noise[start : start + t]
        snr_db = float(rng.uniform(self.noise.snr_min, self.noise.snr_max))
        sig_pow = float(np.mean(np.square(wav)))
        noise_pow = max(float(np.mean(np.square(seg))), 1e-12)
        gain = np.sqrt(sig_pow / (10.0 ** (snr_db / 10.0) * noise_pow))
        return (wav + gain * seg).astype(np.float32)

    def _bucket_for(self, n: int) -> int:
        """Padded width for a batch whose longest item is ``n`` samples.

        Multi-host (``num_shards > 1``) with chunking: the width must be
        HOST-INDEPENDENT — every process contributes its local slice of
        one global array and the shapes must agree without communication
        — so pad to the chunk-max bucket (chunk-truncated lengths never
        exceed it; with B>=32 the local max is almost always the top
        chunk anyway, so the extra padding is ~nil in practice).
        Unchunked multi-host loaders feed per-host (non-global) eval
        paths, where per-batch buckets stay safe.
        """
        if self.num_shards > 1 and self.chunk.enabled:
            n = max(
                n,
                int(max(self.chunk.max_length, max(self.chunk.lengths))
                    * self.sample_rate),
            )
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _make_batch(self, waves, speakers) -> Batch:
        longest = max(len(w) for w in waves)
        t = self._bucket_for(longest)
        int16 = self.transport_dtype == "int16"
        batch = np.zeros((len(waves), t), np.int16 if int16 else np.float32)
        lengths = np.zeros(len(waves), np.int32)
        for i, w in enumerate(waves):
            w = w[:t]
            if int16:
                w = np.clip(w * 32768.0, -32768, 32767).astype(np.int16)
            batch[i, : len(w)] = w
            lengths[i] = len(w)
        return Batch(batch, lengths, np.asarray(speakers, np.int32))

    def _speaker_map(self) -> dict:
        """{speaker_id: [dataset-local indices]} without decoding audio.
        Subset views carry re-derived local ``speakers_utterances``, so the
        SpeakerDataset protocol covers every dataset uniformly."""
        ds = self.dataset
        return {
            ds.speakers_to_id[spk]: list(utts)
            for spk, utts in ds.speakers_utterances.items()
        }

    def _balanced_order(self, rng: np.random.Generator, restrict=None,
                        n_batches: Optional[int] = None) -> np.ndarray:
        """N-speakers x M-utterances batch composition. ``restrict``
        limits candidate utterances to a local-index subset; ``n_batches``
        overrides the epoch batch count."""
        n_spk, m_utt = self.balanced
        by_speaker = self._speaker_map()
        if restrict is not None:
            allowed = set(int(i) for i in restrict)
            by_speaker = {
                s: [u for u in utts if u in allowed]
                for s, utts in by_speaker.items()
            }
            by_speaker = {s: u for s, u in by_speaker.items() if u}
        speakers = sorted(by_speaker)
        if n_batches is None:
            n_batches = len(self.dataset) // self.batch_size
        order = []
        for _ in range(n_batches):
            chosen = rng.choice(speakers, size=min(n_spk, len(speakers)),
                                replace=len(speakers) < n_spk)
            for s in chosen:
                utts = by_speaker[int(s)]
                order.extend(rng.choice(utts, size=m_utt,
                                        replace=len(utts) < m_utt).tolist())
        return np.asarray(order, np.int64)

    def _iter_device_static_shard(self) -> Iterator[Batch]:
        """Static-sharded device-corpus epoch: this shard permutes ITS OWN
        utterance slice and yields descriptor batches. Deterministic in
        ``(seed, epoch, shard_id)``; per-example RNG streams are keyed by
        shard so no two shards share a chunk-draw stream."""
        rng = np.random.default_rng(
            (self.seed, self.epoch, self.shard_id, self.num_shards)
        )
        n_batches = (len(self.dataset) // self.num_shards) // self.batch_size
        if self.balanced is not None:
            order = self._balanced_order(
                rng, restrict=self._device_owned_local, n_batches=n_batches
            )
        else:
            owned = self._device_owned_local
            order = owned[rng.permutation(len(owned))]
        yield from self._device_batches(order, range(n_batches), self.shard_id)

    def _iter_batches(self) -> Iterator[Batch]:
        if self._device_owned_local is not None:
            yield from self._iter_device_static_shard()
            return
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.balanced is not None:
            order = self._balanced_order(rng)
        else:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(order)
        n_full = len(order) // self.batch_size
        tail = len(order) - n_full * self.batch_size
        if self.num_shards > 1:
            # shard WHOLE batches round-robin AFTER composition: balanced
            # (N speakers x M utterances) batches stay intact, and every
            # shard sees the same step count (collectives in lockstep)
            per_shard = n_full // self.num_shards
            my_batches = [
                self.shard_id + k * self.num_shards for k in range(per_shard)
            ]
        else:
            my_batches = list(range(n_full))
            if not self.drop_last and tail:
                my_batches.append(n_full)

        def load(args):
            pos, idx = args
            # per-example RNG keyed by GLOBAL epoch position: deterministic
            # and independent of decode order and of the shard count
            ex_rng = np.random.default_rng((self.seed, self.epoch, int(pos)))
            return self._load_one(int(idx), ex_rng)

        if self._device_corpus is not None:
            # device-resident mode: descriptors only, with the same batch
            # membership (``order``/sharding above) and the same
            # per-example RNG streams
            yield from self._device_batches(order, my_batches)
            return

        pool = None
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            for b in my_batches:
                idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                jobs = [(b * self.batch_size + j, i) for j, i in enumerate(idxs)]
                if pool is not None:
                    results = list(pool.map(load, jobs))
                else:
                    results = [load(j) for j in jobs]
                waves = [r[0] for r in results]
                speakers = [r[1] for r in results]
                yield self._make_batch(waves, speakers)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []

        def worker():
            try:
                for item in self._iter_batches():
                    q.put(item)
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item


def _resample_host(wav: np.ndarray, orig: int, new: int) -> np.ndarray:
    """Host-side polyphase resample (same sinc kernel as the device path)."""
    if orig == new:
        return wav
    import math

    from titanet_torch.ops.augment import _sinc_resample_kernel

    kernels, width = _sinc_resample_kernel(orig, new)
    gcd = math.gcd(orig, new)
    of, nf = orig // gcd, new // gcd
    x = np.pad(wav, (width, width + of))
    n_out = x.shape[0] - kernels.shape[-1] + 1
    starts = np.arange(0, n_out, of)
    segs = x[starts[:, None] + np.arange(kernels.shape[-1])[None, :]]  # [n, K]
    out = segs @ kernels[:, 0, :].T  # [n, nf]
    out = out.reshape(-1)
    target = int(math.ceil(nf * len(wav) / of))
    return out[:target].astype(np.float32)


def _stage(batch: Batch, device: torch.device, stream) -> dict:
    """Copy one host batch to ``device``: pinned host tensors, copied with
    ``non_blocking=True`` on ``stream`` (a side CUDA stream). A
    :class:`~titanet_torch.data.device_corpus.DeviceBatch` is gathered on
    the current stream from its device corpus instead: only its
    descriptor crosses to the card."""
    from titanet_torch.data.device_corpus import DeviceBatch

    if isinstance(batch, DeviceBatch):
        if batch.corpus.device.type != device.type:
            raise ValueError(f"device corpus is on {batch.corpus.device}, batches were asked on {device}")
        wav, lengths, speakers = batch.gather()
        return {"waveform": wav, "lengths": lengths, "speaker_ids": speakers}
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.__dict__.items()}
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}
    with torch.cuda.stream(stream):
        return {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}


def device_prefetch(iterator, device="cuda", size: int = 2):
    """Stage host batches onto the device ``size`` batches ahead of use.

    Yields ``(tensors, batch)``: ``tensors`` is ``{"waveform", "lengths",
    "speaker_ids"}`` on ``device``, ``batch`` the host :class:`Batch` (or
    the :class:`~titanet_torch.data.device_corpus.DeviceBatch`, whose
    windows are gathered on the card). On
    the card each batch is copied from pinned host memory on a side stream
    while the compute stream runs earlier steps; before a batch is yielded
    the compute stream waits for its copy, and every staged tensor is
    marked with ``record_stream`` as used there, so the caching allocator
    cannot hand its memory to a later copy while a step still reads it.
    On the CPU the tensors are plain views of the batch's arrays.
    """
    from titanet_torch._device import resolve_device

    dev = resolve_device(device)
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
    buf: List = []
    it = iter(iterator)

    def stage() -> None:
        batch = next(it)
        buf.append((_stage(batch, dev, side), batch))

    try:
        for _ in range(max(size, 1)):
            stage()
    except StopIteration:
        pass
    while buf:
        tensors, batch = buf.pop(0)
        if side is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_stream(side)
            for t in tensors.values():
                t.record_stream(compute)
        try:
            stage()
        except StopIteration:
            pass
        yield tensors, batch
