"""Device-resident corpus: the training waveforms live in device memory
(port of ``titanet_tpu/data/device_corpus.py``).

The whole corpus is quantized to int16 PCM (the sources' own bit depth),
laid out as ONE flat int16 tensor and uploaded ONCE per process, in 32 MB
slabs through pinned host memory. Each step then ships only a batch
descriptor (crop starts and lengths, ~1 KB) and the window
gather/crop/zero-mask runs on the device (:func:`gather_windows`): the
waveform bytes never cross PCIe after the upload.

Parity: batch composition, chunk draws, bucket choice and zero padding are
the host loader's, draw for draw (the same ``(seed, epoch, position)``
streams; ``DataLoader._plan_one`` mirrors ``DataLoader._load_one``). The
windows equal the host loader's ``transport_dtype="int16"`` batches bit
for bit, and its float32 batches within 2^-15 (one int16 step).

Eligibility: host-side augmentations that transform the waveform (speed,
reverb, noise mixing) refuse device mode; chunking and the in-step
SpecAugment and noise keep it eligible. In a data-parallel run each rank
uploads only its train loader's static shard
(``DataLoader.device_shard_root_indices``) and gathers its own rows of
every step (:meth:`DeviceBatch.gather_global`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

# corpus cache across runs in one process (benchmark campaigns rebuild
# identical datasets per run; re-uploading each time would dominate)
_CORPUS_CACHE: dict = {}


def resolve_base(dataset):
    """Walk Subset views to the root dataset; returns (root, base_of_local)
    where ``base_of_local[i]`` maps view-local index i -> root index."""
    indices = None
    ds = dataset
    while hasattr(ds, "parent") and hasattr(ds, "indices"):
        own = np.asarray(ds.indices, np.int64)
        indices = own if indices is None else own[indices]
        ds = ds.parent
    if indices is None:
        indices = np.arange(len(ds), dtype=np.int64)
    return ds, indices


def corpus_layout(lengths: np.ndarray, include: np.ndarray, tail_pad: int):
    """``(offsets [N] int64, size)`` of the flat corpus: the included
    utterances back to back in index order (``-1`` for the others), then
    ``tail_pad`` zeros. Raises past 2^31 samples, where int32 window starts
    (the JAX package's) would overflow."""
    offsets = np.full(len(lengths), -1, np.int64)
    pos = 0
    for i in include:
        offsets[i] = pos
        pos += int(lengths[i])
    size = pos + tail_pad
    if size >= 2**31:
        # int32 window starts cap the corpus at 2^31 samples ~ 37 hours
        # @ 16 kHz; larger corpora stay host-fed
        raise ValueError(
            f"corpus too large for device residency ({size * 2 / 2**30:.1f}"
            " GiB int16); use the host loader"
        )
    return offsets, size


def _upload(flat: np.ndarray, device: torch.device, slab_bytes: int) -> torch.Tensor:
    """One int16 tensor on ``device``; on a card, copied in ``slab_bytes``
    slabs from pinned host memory."""
    host = torch.from_numpy(flat)
    if device.type != "cuda":
        return host.to(device)
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    slab = max(slab_bytes // flat.itemsize, 1)
    pinned = []  # kept alive until the copies have run
    for a in range(0, len(flat), slab):
        part = host[a:a + slab].pin_memory()
        out[a:a + slab].copy_(part, non_blocking=True)
        pinned.append(part)
    torch.cuda.synchronize(device)
    return out


class DeviceCorpus:
    """Flat int16 PCM corpus on the device + host-side offset/length tables.

    With ``root_indices`` (a static corpus shard) only that subset of the
    root dataset is decoded and uploaded; the host tables stay
    root-indexed (``offsets[i] = -1`` marks an utterance the shard does not
    own), so :meth:`titanet_torch.data.loader.DataLoader._plan_one`
    addresses owned utterances identically in both modes.
    """

    def __init__(self, flat_device, offsets, lengths, speaker_ids,
                 sample_rate, n_owned=None):
        self.flat = flat_device  # torch int16 [S + tail] on the device
        self.offsets = offsets  # np int64 [N]; -1 = not on this shard
        self.lengths = lengths  # np int32 [N] samples per utterance
        self.speaker_ids = speaker_ids  # np int32 [N]
        self.sample_rate = sample_rate
        self.n_owned = len(offsets) if n_owned is None else int(n_owned)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def owns(self, root_idx: int) -> bool:
        return self.offsets[root_idx] >= 0

    @classmethod
    def build(cls, dataset, sample_rate: int, device="cuda", tail_pad: int = 400_000,
              slab_bytes: int = 32 << 20, cache_key=None, root_indices=None):
        """Decode every utterance of the ROOT dataset once (mono, resampled:
        the host loader's decode path), quantize to int16, upload as one
        flat tensor on ``device``.

        ``tail_pad`` zeros terminate the flat tensor so the LAST
        utterance's window can never run off the end (mid-corpus overruns
        are zero-masked in :func:`gather_windows`).

        ``root_indices``: decode/upload ONLY these root-dataset indices (a
        static corpus shard). ``cache_key`` (:func:`corpus_cache_key`)
        reuses a corpus this process already built on the same device.
        """
        from titanet_torch._device import resolve_device
        from titanet_torch.data.loader import _resample_host

        dev = resolve_device(device)
        key = None if cache_key is None else (tuple(cache_key), str(dev))
        if key is not None and key in _CORPUS_CACHE:
            return _CORPUS_CACHE[key]
        n = len(dataset)
        include = (np.arange(n, dtype=np.int64) if root_indices is None
                   else np.asarray(sorted(set(int(i) for i in root_indices)),
                                   np.int64))
        waves, lengths, speakers = [], np.zeros(n, np.int32), np.zeros(n, np.int32)
        for i in include:
            wav, sr, speaker = dataset.get_sample(int(i))
            wav = np.asarray(wav, np.float32)
            if wav.ndim == 2:
                wav = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
            if sr != sample_rate:
                wav = _resample_host(wav, sr, sample_rate)
            q = np.clip(wav * 32768.0, -32768.0, 32767.0).astype(np.int16)
            waves.append(q)
            lengths[i] = len(q)
            speakers[i] = dataset.speakers_to_id[speaker]
        offsets, size = corpus_layout(lengths, include, tail_pad)
        flat = np.zeros(size, np.int16)
        for i, w in zip(include, waves):
            flat[int(offsets[i]):int(offsets[i]) + len(w)] = w
        del waves
        corpus = cls(_upload(flat, dev, slab_bytes), offsets, lengths, speakers,
                     sample_rate, n_owned=len(include))
        if key is not None:
            _CORPUS_CACHE[key] = corpus
        return corpus


def gather_windows(corpus: DeviceCorpus, starts, lengths, t: int) -> torch.Tensor:
    """``[B]`` absolute sample starts + valid lengths -> ``[B, t]`` int16
    windows on the corpus's device, zero past each length (the host
    collate's zero padding). The rows of ``flat.unfold(0, t, 1)`` (a view)
    are indexed by the starts, clamped as XLA's ``dynamic_slice`` clamps
    them; no ``[B, t]`` index tensor is built."""
    flat = corpus.flat
    dev = flat.device
    starts = torch.as_tensor(np.asarray(starts, np.int64)).to(dev, non_blocking=True)
    lengths = torch.as_tensor(np.asarray(lengths, np.int64)).to(dev, non_blocking=True)
    rows = flat.unfold(0, t, 1)[starts.clamp(0, flat.numel() - t)]
    keep = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    return torch.where(keep, rows, torch.zeros((), dtype=flat.dtype, device=dev))


@dataclass
class DeviceBatch:
    """Batch descriptor: host metadata only; the waveforms materialize on
    the device through :meth:`gather`. Duck-types the fields of
    :class:`titanet_torch.data.loader.Batch` that the loops read."""

    corpus: DeviceCorpus
    starts: np.ndarray  # int64 [B] absolute sample starts in corpus.flat
    lengths: np.ndarray  # int32 [B] valid samples per row
    speaker_ids: np.ndarray  # int32 [B]
    t: int  # bucket length (static window width)

    def __len__(self):
        return len(self.speaker_ids)

    def gather(self):
        """``(wav [B, t] int16, lengths [B] int32, speaker_ids [B] int32)``,
        tensors on the corpus's device."""
        dev = self.corpus.device
        wav = gather_windows(self.corpus, self.starts, self.lengths, self.t)
        return (
            wav,
            torch.from_numpy(np.asarray(self.lengths, np.int32)).to(dev),
            torch.from_numpy(np.asarray(self.speaker_ids, np.int32)).to(dev),
        )

    def gather_global(self, mesh, t: Optional[int] = None):
        """This rank's rows of the step's global batch, gathered on its
        device from its own static corpus shard; the waveform bytes never
        visit the host. The global batch is the rank-ordered concatenation
        of the ranks' descriptors (this one holds this rank's rows), all
        gathered at one width: ``t``, or the widest rank's bucket (one
        max-reduce over ``mesh``). ``(wav [B, t] int16, lengths,
        speaker_ids)`` as :meth:`gather`."""
        if t is None:
            t = mesh.agree_max([self.t])[0]
        return replace(self, t=int(t)).gather()


def corpus_cache_key(root_dataset) -> Optional[tuple]:
    """A content-identity key for cross-run corpus reuse (same process).
    Synthetic datasets are keyed by their generation parameters; disk
    corpora by identity (no reuse across dataset objects)."""
    key = getattr(root_dataset, "_synth_cache_key", None)
    if key is not None:
        return ("synthetic",) + tuple(key)
    return ("id", id(root_dataset))
