"""Batched variable-length embedding extraction (port of
``titanet_tpu/train/extractor.py``).

Utterances are padded to a few geometric length buckets and embedded in
fixed-size batches with frame masks, so a padded embedding equals the
utterance's solo embedding. Utterances longer than the largest bucket are
cut into overlapping windows whose unit-norm embeddings are averaged and
re-normalized. ``quantized=True`` embeds through the int8 tree
(:mod:`titanet_torch.models.quantized`), built once from the model.

A batch of ``n`` real rows is handed to the step at the smallest row
class that holds it (:func:`row_classes`: ``batch_size``, ``batch_size //
2``, ... down to 8 rows; ``batch_size`` alone under 16), so a bucket's
last, partial batch computes few filler rows; full batches keep
``batch_size`` rows. The JAX package's extractor pads every batch to
``batch_size``: the two differ in batch shapes, not in answers.

On the card every (bucket, row class) shape is one CUDA graph
(:mod:`titanet_torch.train.capture`), captured by :meth:`SpeakerEmbedder.warmup`
or by the first batch of that shape and replayed by every later one;
``capture=False`` embeds eagerly, ``capture`` as
:func:`titanet_torch.train.state.embed_step`'s.

A call's batches are staged in two reused slots (``_Slot``: the padded
batch, its lengths and its embeddings; pinned host memory on the card, so
that neither copy waits for the card). Batch k is padded into slot k % 2,
handed to the step and its readback queued before batch k - 1 is read
back: the host pads the next batch while the card runs the last, and
nothing between two readbacks waits for the card. A slot is refilled only
after the batch that last used it was read back, and a fill zeros only the
samples its rows may still hold past their lengths. The slots hold
``batch_size`` rows of the first call's largest bucket, and of the largest
bucket once a later call needs longer rows; one lock lets one call at a
time use them. Every batch of a call is read back before it returns.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from titanet_torch._device import resolve_device
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.train.state import embed_step, embed_step_quantized
from titanet_torch.utils.profiling import span

_REQUESTS = itertools.count()  # the process's embedding requests, the id of each one's spans


def row_classes(batch_size: int) -> List[int]:
    """The row counts a batch is handed to the step with, largest first:
    ``batch_size`` halved while the half holds at least 8 rows."""
    classes = [batch_size]
    while classes[-1] // 2 >= 8:
        classes.append(classes[-1] // 2)
    return classes


def rows_for(n: int, batch_size: int) -> int:
    """The smallest row class (:func:`row_classes`) that holds ``n`` rows."""
    return min(c for c in row_classes(batch_size) if c >= n)


def geometric_buckets(
    min_samples: int = 16000, max_samples: int = 480000, growth: float = 1.5
) -> List[int]:
    """Length buckets from 1 s to 30 s (defaults), geometrically spaced."""
    buckets = [min_samples]
    while buckets[-1] < max_samples:
        buckets.append(int(buckets[-1] * growth))
    return buckets


class _Slot:
    """One staging slot: ``wav`` (flat float32, viewed as ``[rows,
    bucket]`` for each batch), the batch's ``lengths`` and ``out``, the
    ``[rows, E]`` float32 embeddings read back into, in pinned memory on the
    card; ``done``, the event recorded after the readback copy on the card.
    ``bucket`` is the width ``wav`` was last filled at and ``held[j]`` the
    samples row ``j`` (at offset ``j * bucket``) may hold past zero, so a
    fill zeros only those; a batch uses the slot's first rows."""

    def __init__(self, rows: int, samples: int, emb: int, pin: bool):
        self.wav = torch.zeros(samples, dtype=torch.float32, pin_memory=pin)
        self.lengths = torch.ones(rows, dtype=torch.int32, pin_memory=pin)
        self.out = torch.zeros(rows, emb, dtype=torch.float32, pin_memory=pin)
        self.done = torch.cuda.Event() if pin else None
        self.bucket = 0
        self.held = np.zeros(rows, np.int64)
        self.rows = 0  # the real rows of the batch last launched

    def fill(self, group: List[np.ndarray], bucket: int):
        """``group`` padded to ``[rows, bucket]`` with zeros, ``rows`` the
        smallest row class that holds it (:func:`rows_for` of the slot's
        rows), the rows past it zeros of length 1 (harmless filler rows) ->
        (waveform ``[rows, bucket]``, lengths ``[rows]``) tensors over the
        slot's memory. Rows past ``rows`` keep what they hold."""
        flat = self.wav.numpy()
        if bucket != self.bucket:  # the rows move: zero what the last width's rows held
            for j in np.flatnonzero(self.held):
                flat[j * self.bucket : j * self.bucket + self.held[j]] = 0
            self.held[:] = 0
            self.bucket = bucket
        rows = rows_for(len(group), len(self.held))
        batch = flat[: rows * bucket].reshape(rows, bucket)
        lengths = self.lengths.numpy()
        for j in range(rows):
            real = j < len(group)
            n = len(group[j]) if real else 0
            if real:
                batch[j, :n] = group[j]
            if self.held[j] > n:
                batch[j, n : self.held[j]] = 0
            self.held[j] = n
            lengths[j] = n if real else 1
        return self.wav[: rows * bucket].view(rows, bucket), self.lengths[:rows]

    def launch_readback(self, emb: torch.Tensor, rows: int) -> None:
        """Queue the copy of ``emb``'s first ``rows``, the real ones, into
        ``out`` (no wait on the card)."""
        self.rows = rows
        self.out[:rows].copy_(emb[:rows].float(), non_blocking=self.done is not None)
        if self.done is not None:
            self.done.record(torch.cuda.current_stream(emb.device))

    def read(self) -> np.ndarray:
        """The real rows' embeddings of the batch this slot last launched,
        once its readback copy has run."""
        with span("embed.readback"):
            if self.done is not None:
                self.done.synchronize()
            return self.out[: self.rows].numpy().copy()


class SpeakerEmbedder:
    def __init__(
        self,
        model,
        frontend: Optional[FrontendConfig] = None,
        buckets: Optional[Sequence[int]] = None,
        batch_size: int = 32,
        window_overlap: float = 0.5,
        quantized: bool = False,
        device="cuda",
        capture: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        self.capture = capture
        self.model = model
        self.frontend = frontend or FrontendConfig.from_ms()
        self.buckets = sorted(buckets) if buckets else geometric_buckets()
        self.batch_size = batch_size
        self.window_overlap = window_overlap
        self._slots: Optional[List[_Slot]] = None  # the batches' staging (_staging)
        self._lock = threading.Lock()  # one call at a time uses the slots
        self.qtree = None
        if quantized:
            # int8 encoder products (titanet_torch.models.quantized): the
            # tree is built once, here
            from titanet_torch.models.quantized import quantize_titanet

            self.qtree = quantize_titanet(model)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _staging(self, bucket: int) -> List[_Slot]:
        """The two staging slots, with rows of at least ``bucket``
        samples: the first call makes them for its largest bucket, a later
        call that needs longer rows makes them again for the embedder's
        largest bucket."""
        samples = self.batch_size * bucket
        if self._slots is None or self._slots[0].wav.numel() < samples:
            if self._slots is not None:
                samples = self.batch_size * max(bucket, self.buckets[-1])
            pin = self.device.type == "cuda"
            self._slots = [_Slot(self.batch_size, samples, self.model.embedding_size, pin) for _ in range(2)]
        return self._slots

    def _embed_batches(self, batches: List[tuple]) -> List[np.ndarray]:
        """``batches`` (``(bucket, waveforms)``, at most ``batch_size``
        each) -> each one's embeddings, in order. Batch k is padded into
        slot k % 2 and launched before batch k - 1 is read back, so the
        host pads the next batch while the card runs the last; every batch
        is read back before this returns (module docstring)."""
        out = []
        with self._lock:
            slots = self._staging(max(bucket for bucket, _ in batches))
            pending = None  # the slot of the batch launched and not yet read back
            try:
                for k, (bucket, group) in enumerate(batches):
                    slot = slots[k % 2]
                    with span("embed.pad", bucket=bucket, real_rows=len(group),
                              in_flight=int(pending is not None)) as sp:
                        wav, lengths = slot.fill(group, bucket)
                        if sp:  # the rows handed to the step
                            sp.count(rows=len(lengths), computed_samples=wav.numel(),
                                     real_samples=sum(len(w) for w in group))
                    if self.qtree is not None:
                        emb = embed_step_quantized(
                            self.qtree, wav, lengths,
                            frontend=self.frontend, masked=True, device=self.device, capture=self.capture,
                        )
                    else:
                        emb = embed_step(
                            self.model, wav, lengths,
                            frontend=self.frontend, masked=True, device=self.device, capture=self.capture,
                        )
                    slot.launch_readback(emb, len(group))
                    if pending is not None:
                        out.append(pending.read())
                    pending = slot
                out.append(pending.read())
            except BaseException:
                if self.device.type == "cuda":
                    # the slots are reused only after every copy from or into them has run
                    torch.cuda.current_stream(self.device).synchronize()
                raise
        return out

    def _batches(self, wavs: List[np.ndarray], bucket: int) -> List[tuple]:
        bs = self.batch_size
        return [(bucket, wavs[i : i + bs]) for i in range(0, len(wavs), bs)]

    def _embed_padded(self, wavs: List[np.ndarray], bucket: int) -> np.ndarray:
        return np.concatenate(self._embed_batches(self._batches(wavs, bucket)))

    def _windows(self, wav: np.ndarray) -> List[np.ndarray]:
        cap = self.buckets[-1]
        hop = int(cap * (1.0 - self.window_overlap))
        starts = list(range(0, max(len(wav) - cap, 0) + 1, hop))
        if not starts:
            return [wav]
        wins = [wav[s : s + cap] for s in starts]
        if starts[-1] + cap < len(wav):
            wins.append(wav[-cap:])
        return wins

    def warmup(self) -> None:
        """Run every (bucket, row class) shape once: on the card this
        captures each shape's graph, so that no request pays for a
        capture (the JAX package compiles each executable here). Largest
        bucket first, and largest class first within a bucket: the graphs
        share one memory pool, and a smaller graph's capture reuses the
        blocks a larger one freed, where in rising order each needs blocks
        larger than any freed before it."""
        classes = row_classes(self.batch_size)
        for bucket in reversed(self.buckets):
            zeros = np.zeros(bucket, np.float32)
            for smaller in classes[1:] + [0]:  # the fewest rows that take each class
                self._embed_padded([zeros] * (smaller + 1), bucket)

    def embed(self, waveforms: Sequence[np.ndarray]) -> np.ndarray:
        """-> unit-norm embeddings [len(waveforms), E], original order."""
        with span("embed.request", id=next(_REQUESTS)) as request:
            with span("embed.plan"):
                waveforms = [np.asarray(w, np.float32).reshape(-1) for w in waveforms]
                cap = self.buckets[-1]
                flat: List[np.ndarray] = []
                owner: List[int] = []
                for i, w in enumerate(waveforms):
                    for win in (self._windows(w) if len(w) > cap else [w]):
                        flat.append(win)
                        owner.append(i)

                order = np.argsort([self._bucket_for(len(w)) for w in flat], kind="stable")
                groups = []  # (bucket, indices into flat): runs of one bucket in that order
                pos = 0
                while pos < len(order):
                    bucket = self._bucket_for(len(flat[order[pos]]))
                    group = [order[pos]]
                    while (
                        pos + len(group) < len(order)
                        and self._bucket_for(len(flat[order[pos + len(group)]])) == bucket
                    ):
                        group.append(order[pos + len(group)])
                    groups.append((bucket, group))
                    pos += len(group)
                results = np.zeros((len(flat), self.model.embedding_size), np.float32)
            if request:
                request.count(waveforms=len(waveforms), windows=len(flat),
                              samples=sum(len(w) for w in waveforms))

            batches = [b for bucket, group in groups for b in self._batches([flat[g] for g in group], bucket)]
            if batches:
                results[np.concatenate([group for _, group in groups])] = np.concatenate(
                    self._embed_batches(batches))

            with span("embed.merge"):
                out = np.zeros((len(waveforms), self.model.embedding_size), np.float32)
                counts = np.zeros(len(waveforms), np.int64)
                for k, i in enumerate(owner):
                    out[i] += results[k]
                    counts[i] += 1
                out /= np.maximum(counts[:, None], 1)
                out /= np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
            return out
