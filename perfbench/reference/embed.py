"""Plain embedding of whole utterances, in float32.

A serving request embeds utterances of any length: an utterance longer
than the largest length bucket is cut into windows of that length, every
``bucket * (1 - overlap)`` samples, plus one ending at its last sample;
each window is zero-padded to the smallest bucket that holds it, its
frames past its length masked; the window embeddings are made unit norm,
averaged, and the average made unit norm. The buckets grow geometrically
from ``min_samples`` by ``growth`` until one reaches ``max_samples``.

This works out the buckets, the padding and the windows again from those
rules; plain torch and numpy only, nothing of the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference.frontend import log_mel
from perfbench.reference.titanet import Net, unit


def geometric_buckets(min_samples: int, max_samples: int, growth: float) -> List[int]:
    buckets = [int(min_samples)]
    while buckets[-1] < max_samples:
        buckets.append(int(buckets[-1] * growth))
    return buckets


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def window_lengths(n: int, buckets: Sequence[int], overlap: float) -> List[tuple]:
    """``(start, length)`` of the windows an utterance of ``n`` samples is
    embedded as."""
    cap = buckets[-1]
    if n <= cap:
        return [(0, n)]
    hop = int(cap * (1.0 - overlap))
    starts = list(range(0, max(n - cap, 0) + 1, hop))
    out = [(s, cap) for s in starts]
    if starts[-1] + cap < n:
        out.append((n - cap, cap))
    return out


@torch.no_grad()
def embed_utterances(weights: Dict[str, torch.Tensor], cfg: dict, waves: Sequence[np.ndarray],
                     buckets: Sequence[int], overlap: float, device, batch_size: int, rnd=lambda x: x,
                     dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Unit embeddings ``[len(waves), E]`` (f32) of whole utterances, the
    network computed in ``dtype`` (:class:`~perfbench.reference.titanet.Net`).
    The windows go in batches of ``batch_size`` rows of one bucket, the
    rows that are left filled with one-sample zero rows, as a serving call
    shapes them: a product's summation order can depend on its shape, and
    in bf16 that shows."""
    net = Net(weights, cfg, rnd=rnd, dtype=dtype)
    fe = cfg["frontend"]
    groups: Dict[int, List[tuple]] = {}
    counts = np.zeros(len(waves), np.int64)
    for i, w in enumerate(waves):
        for start, n in window_lengths(len(w), buckets, overlap):
            groups.setdefault(bucket_for(n, buckets), []).append((i, start, n))
            counts[i] += 1
    acc = torch.zeros(len(waves), cfg["embedding_size"], dtype=torch.float32, device=device)
    for width, wins in sorted(groups.items()):
        for a in range(0, len(wins), batch_size):
            part = wins[a:a + batch_size]
            x = torch.zeros(batch_size, width, dtype=torch.float32, device=device)
            lengths = torch.ones(batch_size, dtype=torch.int64)
            for r, (i, start, n) in enumerate(part):
                x[r, :n] = torch.from_numpy(np.asarray(waves[i][start:start + n], np.float32)).to(device)
                lengths[r] = n
            mel, mask = log_mel(x, fe, lengths=lengths)
            emb = unit(net(mel, mask)).float()
            for r, (i, _, _) in enumerate(part):
                acc[i] += emb[r]
    out = unit(acc / torch.as_tensor(counts, device=device, dtype=torch.float32)[:, None])
    return out.cpu().numpy()
