"""Batched variable-length embedding extraction (port of
``titanet_tpu/train/extractor.py``).

Utterances are padded to a few geometric length buckets and embedded in
fixed-size batches with frame masks, so a padded embedding equals the
utterance's solo embedding. Utterances longer than the largest bucket are
cut into overlapping windows whose unit-norm embeddings are averaged and
re-normalized. ``quantized=True`` embeds through the int8 tree
(:mod:`titanet_torch.models.quantized`), built once from the model.

On the card every (bucket, ``batch_size``) shape is one CUDA graph
(:mod:`titanet_torch.train.capture`), captured by :meth:`SpeakerEmbedder.warmup`
or by the first batch of that shape and replayed by every later one;
``capture=False`` embeds eagerly, ``capture`` as
:func:`titanet_torch.train.state.embed_step`'s.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np

from titanet_torch._device import resolve_device
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.train.state import embed_step, embed_step_quantized
from titanet_torch.utils.profiling import span

_REQUESTS = itertools.count()  # the process's embedding requests, the id of each one's spans


def geometric_buckets(
    min_samples: int = 16000, max_samples: int = 480000, growth: float = 1.5
) -> List[int]:
    """Length buckets from 1 s to 30 s (defaults), geometrically spaced."""
    buckets = [min_samples]
    while buckets[-1] < max_samples:
        buckets.append(int(buckets[-1] * growth))
    return buckets


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

    def _embed_padded(self, wavs: List[np.ndarray], bucket: int) -> np.ndarray:
        out = []
        bs = self.batch_size
        for i in range(0, len(wavs), bs):
            group = wavs[i : i + bs]
            with span("embed.pad", bucket=bucket, rows=bs, real_rows=len(group),
                      computed_samples=bs * bucket) as sp:
                batch = np.zeros((bs, bucket), np.float32)
                lengths = np.zeros(bs, np.int32)
                for j, w in enumerate(group):
                    batch[j, : len(w)] = w
                    lengths[j] = len(w)
                lengths[len(group):] = 1  # harmless filler rows
                if sp:
                    sp.count(real_samples=int(lengths[: len(group)].sum()))
            if self.qtree is not None:
                emb = embed_step_quantized(
                    self.qtree, batch, lengths,
                    frontend=self.frontend, masked=True, device=self.device, capture=self.capture,
                )
            else:
                emb = embed_step(
                    self.model, batch, lengths,
                    frontend=self.frontend, masked=True, device=self.device, capture=self.capture,
                )
            with span("embed.readback"):
                out.append(emb.float().cpu().numpy()[: len(group)])
        return np.concatenate(out)

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
        """Run every (bucket, batch_size) shape once: on the card this
        captures each shape's graph, so that no request pays for a
        capture (the JAX package compiles each executable here). Largest
        bucket first: the graphs share one memory pool, and a smaller
        graph's capture reuses the blocks a larger one freed, where in
        rising order each needs blocks larger than any freed before it."""
        for bucket in reversed(self.buckets):
            self._embed_padded([np.zeros(bucket, np.float32)], bucket)

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

            for bucket, group in groups:
                results[np.asarray(group)] = self._embed_padded([flat[g] for g in group], bucket)

            with span("embed.merge"):
                out = np.zeros((len(waveforms), self.model.embedding_size), np.float32)
                counts = np.zeros(len(waveforms), np.int64)
                for k, i in enumerate(owner):
                    out[i] += results[k]
                    counts[i] += 1
                out /= np.maximum(counts[:, None], 1)
                out /= np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
            return out
