"""Speaker diarization on top of the embedding stack (the port's own copy
of ``titanet_tpu/train/diarize.py``: the same numpy, so the same affinity
clusters to the same labels in both packages).

No reference counterpart (Wadaboa/titanet stops at verification); this is
the standard production companion of a speaker-embedding model (cf. NeMo's
TitaNet-based diarizer): slide a window over the audio, embed every window
(batched, bucketed — :class:`titanet_torch.train.extractor.SpeakerEmbedder`),
cluster the windows spectrally with an eigengap speaker-count estimate, and
merge adjacent same-speaker windows into segments.

Pure numpy/scipy host-side math around the device embedding batch — the
clustering problem is tiny (hundreds of windows) next to the embedding
compute, so it stays off-device by design.

Includes a frame-based Diarization Error Rate (optimal label mapping via
the Hungarian algorithm) so the pipeline is testable end-to-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Segment:
    start: float  # seconds
    end: float
    speaker: int

    def __iter__(self):  # tuple-compat: start, end, speaker = seg
        yield self.start
        yield self.end
        yield self.speaker


def cosine_affinity(embeddings: np.ndarray) -> np.ndarray:
    """Pairwise cosine similarity mapped to [0, 1] (``(cos + 1) / 2``)."""
    x = np.asarray(embeddings, np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return (x @ x.T + 1.0) / 2.0


def _kmeans(x: np.ndarray, k: int, seed: int = 0, iters: int = 100,
            n_init: int = 10) -> np.ndarray:
    """Seeded Lloyd k-means (numpy; k and N are tiny here)."""
    rng = np.random.default_rng(seed)
    best_labels, best_cost = None, np.inf
    for _ in range(n_init):
        centers = x[rng.choice(len(x), size=k, replace=False)]
        labels = np.zeros(len(x), np.int64)
        for _ in range(iters):
            d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            new_labels = d.argmin(1)
            if (new_labels == labels).all():
                break
            labels = new_labels
            for j in range(k):
                pts = x[labels == j]
                if len(pts):
                    centers[j] = pts.mean(0)
        cost = ((x - centers[labels]) ** 2).sum()
        if cost < best_cost:
            best_cost, best_labels = cost, labels.copy()
    return best_labels


def refine_affinity(a: np.ndarray, p_percentile: float = 92.0) -> np.ndarray:
    """Row-wise percentile sharpening (Wang et al., arXiv:1710.10468 §V):
    keep each row's strongest affinities, damp the rest 100x, then
    symmetrize. A dense cosine graph connects ALL windows (cross-speaker
    cosine affinity sits near 0.5, not 0), which hides the block structure
    from the Laplacian spectrum — the eigengap then always says k=1."""
    thresh = np.percentile(a, p_percentile, axis=1, keepdims=True)
    refined = np.where(a >= thresh, a, a * 0.01)
    return (refined + refined.T) / 2.0


def nme_estimate(
    a: np.ndarray, max_speakers: int = 8
) -> Tuple[int, np.ndarray]:
    """NME-SC speaker-count + graph-sparsity estimation (Park et al.,
    arXiv:1909.01008, the auto-tuning used by production diarizers):

    For each row-sparsity p (top-p binarized affinity, symmetrized), take
    the unnormalized-Laplacian eigengap g_p = max_k (lambda_{k+1} -
    lambda_k) normalized by lambda_max, and pick the p minimizing the NME
    ratio r(p) = (p/n) / g_p — the sparsest graph with the cleanest block
    structure. Returns (k, binarized_affinity_at_p*).

    Fixed-percentile sharpening (:func:`refine_affinity`) needs its one
    free parameter tuned per corpus — too sparse fragments speakers, too
    dense percolates everything into k=1 (both observed); NME makes that
    choice from the data itself.
    """
    n = len(a)
    best = None
    for p in range(2, max(3, n // 2 + 1)):
        idx = np.argsort(-a, axis=1)[:, :p]
        b = np.zeros_like(a)
        b[np.arange(n)[:, None], idx] = 1.0
        b = np.maximum(b, b.T)
        lam = np.linalg.eigvalsh(np.diag(b.sum(1)) - b)
        lam = np.maximum(lam, 0.0)
        kmax = min(max_speakers, n - 1)
        gaps = lam[1:kmax + 1] - lam[:kmax]
        k = int(np.argmax(gaps)) + 1
        g = gaps[k - 1] / max(lam[-1], 1e-12)
        r = (p / n) / max(g, 1e-12)
        if best is None or r < best[0]:
            best = (r, k, b)
    return best[1], best[2]


def spectral_cluster(
    embeddings: np.ndarray,
    n_speakers: Optional[int] = None,
    max_speakers: int = 8,
    seed: int = 0,
    p_percentile: float = 92.0,
) -> np.ndarray:
    """Spectral clustering with NME-SC speaker-count estimation.

    Normalized-Laplacian recipe (Von Luxburg tutorial): with ``n_speakers``
    given, sharpen the cosine affinity at ``p_percentile``
    (:func:`refine_affinity`); with ``n_speakers=None``, estimate both the
    count and the graph sparsity via :func:`nme_estimate`. Cluster the
    row-normalized first-k eigenvectors of ``D^-1/2 (D - A) D^-1/2`` with
    k-means.
    """
    a = cosine_affinity(embeddings)
    n = len(a)
    if n == 1:
        return np.zeros(1, np.int64)
    if n_speakers is None:
        n_speakers, a = nme_estimate(a, max_speakers=max_speakers)
    else:
        # keep at least 2 neighbors per row under the percentile cut
        a = refine_affinity(a, min(p_percentile, 100.0 * (1.0 - 2.0 / n)))
    if n_speakers <= 1:
        return np.zeros(n, np.int64)
    d = a.sum(1)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    lap = np.eye(n) - (a * inv_sqrt[:, None]) * inv_sqrt[None, :]
    _, eigvecs = np.linalg.eigh(lap)
    emb = eigvecs[:, :n_speakers]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    return _kmeans(emb, n_speakers, seed=seed)


def ahc_cluster(
    embeddings: np.ndarray,
    threshold: float,
    max_speakers: int = 8,
) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine similarity with a
    calibrated stop threshold — the classic production alternative to
    NME-SC (e.g. Kaldi/x-vector diarization recipes): merge the two
    closest clusters while their average pairwise cosine similarity
    exceeds ``threshold``; the threshold is tuned once on a DEV
    conversation set (:func:`calibrate_ahc_threshold`) and then carries
    the operating point explicitly, where NME-SC re-estimates it from
    each conversation's eigengap (noisy for short or imbalanced
    conversations).

    O(n^3) worst case on hundreds of windows — host-side trivia next to
    the embedding compute.
    """
    x = np.asarray(embeddings, np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    n = len(x)
    if n == 0:
        return np.zeros(0, np.int64)
    sim = x @ x.T
    clusters = [[i] for i in range(n)]
    # average-linkage similarity between clusters a, b = mean of pairwise
    # window similarities; maintained incrementally via summed rows
    while len(clusters) > 1:
        best, bi, bj = -np.inf, -1, -1
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                s = sim[np.ix_(clusters[i], clusters[j])].mean()
                if s > best:
                    best, bi, bj = s, i, j
        if best < threshold and len(clusters) <= max_speakers:
            break
        clusters[bi] = clusters[bi] + clusters[bj]
        del clusters[bj]
    labels = np.zeros(n, np.int64)
    for lab, members in enumerate(clusters):
        labels[members] = lab
    return labels


def calibrate_ahc_threshold(
    dev_conversations,
    embedder,
    sample_rate: int,
    thresholds: Sequence[float] = tuple(np.arange(0.30, 0.91, 0.05)),
    window_s: float = 1.5,
    hop_s: float = 0.75,
    max_speakers: int = 8,
) -> Tuple[float, dict]:
    """Sweep the AHC stop threshold on a DEV set of reference-annotated
    conversations and return ``(best_threshold, {threshold: mean_DER})``.

    ``dev_conversations``: iterable of ``(waveform, reference_segments)``
    where reference segments are ``(start_s, end_s, speaker)`` triples.
    Embeds each conversation ONCE and re-clusters per threshold (the
    sweep costs host-side clustering only).
    """
    wins_per_conv = []
    for wav, ref in dev_conversations:
        wav = np.asarray(wav, np.float32).reshape(-1)
        win = int(window_s * sample_rate)
        hop = max(1, int(hop_s * sample_rate))
        starts = list(range(0, max(len(wav) - win, 0) + 1, hop)) or [0]
        windows = [wav[s:s + win] for s in starts]
        emb = np.asarray(embedder.embed(windows))
        t0 = [s / sample_rate for s in starts]
        t1 = [min(s + win, len(wav)) / sample_rate for s in starts]
        wins_per_conv.append((emb, t0, t1, ref))
    sweep = {}
    for th in thresholds:
        ders = []
        for emb, t0, t1, ref in wins_per_conv:
            labels = ahc_cluster(emb, float(th), max_speakers=max_speakers)
            hyp = merge_windows(labels, t0, t1)
            ders.append(diarization_error_rate(ref, hyp))
        sweep[float(th)] = float(np.mean(ders))
    best = min(sweep, key=sweep.get)
    return best, sweep


def overlap_assign(
    embeddings: np.ndarray,
    labels: np.ndarray,
    overlap_threshold: float,
    overlap_margin: float = 0.15,
) -> np.ndarray:
    """Per-window secondary speaker labels (``-1`` = none): flag windows
    whose embedding sits *between* two cluster centroids.

    A window containing two simultaneous (or back-to-back) speakers embeds
    near the midpoint of their centroids, so BOTH centroid cosines are
    moderately high and close together. A window is flagged when the
    runner-up centroid's cosine clears ``overlap_threshold`` AND trails the
    primary's by at most ``overlap_margin``. Both knobs are calibrated on a
    dev conversation set (:func:`calibrate_overlap_threshold`). This is an
    embedding-geometry heuristic, not a trained overlap detector — the
    production upgrade path is an OSD model feeding the same emission
    machinery.
    """
    x = np.asarray(embeddings, np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    labels = np.asarray(labels, np.int64)
    sec = np.full(len(x), -1, np.int64)
    ids = np.unique(labels)
    if len(ids) < 2:
        return sec
    cents = np.stack([x[labels == j].mean(0) for j in ids])
    cents = cents / np.maximum(
        np.linalg.norm(cents, axis=-1, keepdims=True), 1e-12
    )
    sims = x @ cents.T  # [n_windows, n_clusters]
    pos = {int(j): p for p, j in enumerate(ids)}
    for i in range(len(x)):
        prim = pos[int(labels[i])]
        rest = np.delete(np.arange(len(ids)), prim)
        second = rest[int(np.argmax(sims[i, rest]))]
        if (
            sims[i, second] >= overlap_threshold
            and sims[i, prim] - sims[i, second] <= overlap_margin
        ):
            sec[i] = int(ids[second])
    return sec


def _secondary_segments(
    sec: np.ndarray,
    primary: Sequence[int],
    starts: Sequence[float],
    ends: Sequence[float],
) -> List[Segment]:
    """Turn per-window secondary labels into segments: consecutive windows
    emitting the same secondary speaker form one segment. The overlap
    usually lives at the end of the run facing the neighbor whose PRIMARY
    label matches the secondary speaker, so that edge window contributes
    only its inner half (full span when both/neither neighbor matches)."""
    segs: List[Segment] = []
    i, n = 0, len(sec)
    while i < n:
        s = int(sec[i])
        if s < 0:
            i += 1
            continue
        j = i
        while j + 1 < n and int(sec[j + 1]) == s:
            j += 1
        lo, hi = float(starts[i]), float(ends[j])
        nxt = j + 1 < n and int(primary[j + 1]) == s
        prv = i > 0 and int(primary[i - 1]) == s
        if nxt and not prv:
            lo = (float(starts[i]) + float(ends[i])) / 2.0
        elif prv and not nxt:
            hi = (float(starts[j]) + float(ends[j])) / 2.0
        segs.append(Segment(lo, hi, s))
        i = j + 1
    return segs


def calibrate_overlap_threshold(
    dev_conversations,
    embedder,
    sample_rate: int,
    thresholds: Sequence[float] = tuple(np.arange(0.40, 0.91, 0.05)),
    margins: Sequence[float] = (0.05, 0.10, 0.20, 0.35, 0.50),
    window_s: float = 1.5,
    hop_s: float = 0.75,
    max_speakers: int = 8,
    n_speakers: Optional[int] = None,
    seed: int = 0,
) -> Tuple[Optional[Tuple[float, float]], dict]:
    """Sweep the overlap-emission knobs on a DEV set of conversations whose
    reference annotations contain overlapped speech; returns
    ``(best, {params: mean_DER})`` where ``best`` is ``(threshold, margin)``
    or ``None`` when emitting nothing beats every swept setting (the sweep
    dict carries the no-emission baseline under key ``None``).

    Embeds and clusters each conversation ONCE (labels do not depend on the
    overlap knobs); the sweep costs host-side assignment + DER only.
    """
    per_conv = []
    for wav, ref in dev_conversations:
        wav = np.asarray(wav, np.float32).reshape(-1)
        win = int(window_s * sample_rate)
        hop = max(1, int(hop_s * sample_rate))
        starts = list(range(0, max(len(wav) - win, 0) + 1, hop)) or [0]
        windows = [wav[s:s + win] for s in starts]
        emb = np.asarray(embedder.embed(windows))
        labels = spectral_cluster(
            emb, n_speakers=n_speakers, max_speakers=max_speakers, seed=seed
        )
        t0 = [s / sample_rate for s in starts]
        t1 = [min(s + win, len(wav)) / sample_rate for s in starts]
        base = merge_windows(labels, t0, t1)
        per_conv.append((emb, labels, t0, t1, base, ref))
    sweep: dict = {}
    sweep[None] = float(
        np.mean([
            diarization_error_rate(ref, base)
            for _, _, _, _, base, ref in per_conv
        ])
    )
    for th in thresholds:
        for mg in margins:
            ders = []
            for emb, labels, t0, t1, base, ref in per_conv:
                sec = overlap_assign(emb, labels, float(th), float(mg))
                hyp = list(base) + _secondary_segments(sec, labels, t0, t1)
                ders.append(diarization_error_rate(ref, hyp))
            sweep[(float(th), float(mg))] = float(np.mean(ders))
    best = min(sweep, key=sweep.get)
    return best, sweep


def merge_windows(
    labels: Sequence[int], starts: Sequence[float], ends: Sequence[float]
) -> List[Segment]:
    """Merge consecutive same-speaker windows into segments; overlapping
    window boundaries split at the midpoint between window starts."""
    segments: List[Segment] = []
    for i, lab in enumerate(labels):
        start = starts[i] if i == 0 else (starts[i] + ends[i - 1]) / 2
        end = ends[i] if i == len(labels) - 1 else (ends[i] + starts[i + 1]) / 2
        start, end = max(start, starts[i]), min(end, ends[i] + (ends[i] - starts[i]))
        if segments and segments[-1].speaker == int(lab):
            segments[-1].end = end
        else:
            segments.append(Segment(start, end, int(lab)))
    return segments


def energy_vad(
    waveform: np.ndarray,
    sample_rate: int,
    frame_s: float = 0.03,
    threshold_db: float = -35.0,
    hangover_s: float = 0.2,
    min_speech_s: float = 0.2,
) -> List[Tuple[float, float]]:
    """Energy voice-activity detection: speech = frames whose RMS exceeds
    ``threshold_db`` relative to the waveform's peak RMS frame, smoothed by
    a ``hangover`` (short gaps bridged), regions under ``min_speech_s``
    dropped. Returns ``[(start_s, end_s)]`` speech regions.

    Deliberately simple (a trained VAD model is a different project) but
    enough to keep silence/noise out of the diarizer's windows — silence
    windows otherwise embed to an arbitrary cluster of their own.
    """
    wav = np.asarray(waveform, np.float32).reshape(-1)
    frame = max(1, int(frame_s * sample_rate))
    n = len(wav) // frame
    if n == 0:
        return [(0.0, len(wav) / sample_rate)] if len(wav) else []
    rms = np.sqrt(
        np.mean(wav[: n * frame].reshape(n, frame) ** 2, axis=1) + 1e-12
    )
    db = 20.0 * np.log10(rms / max(rms.max(), 1e-12))
    speech = db > threshold_db
    # hangover: bridge gaps shorter than hangover_s
    gap = max(1, int(round(hangover_s / frame_s)))
    idx = np.flatnonzero(speech)
    if len(idx) == 0:
        return []
    regions = []
    start = prev = idx[0]
    for i in idx[1:]:
        if i - prev > gap:
            regions.append((start, prev + 1))
            start = i
        prev = i
    regions.append((start, prev + 1))
    out = []
    for s, e in regions:
        t0, t1 = s * frame_s, min(e * frame_s, len(wav) / sample_rate)
        if t1 - t0 >= min_speech_s:
            out.append((t0, t1))
    return out


def diarize(
    waveform: np.ndarray,
    sample_rate: int,
    embedder,
    window_s: float = 1.5,
    hop_s: float = 0.75,
    n_speakers: Optional[int] = None,
    max_speakers: int = 8,
    seed: int = 0,
    vad: bool = False,
    clustering: str = "nmesc",
    ahc_threshold: float = 0.6,
    overlap_threshold: Optional[float] = None,
    overlap_margin: float = 0.15,
) -> List[Segment]:
    """Full pipeline: [VAD ->] window -> batched embed -> cluster -> merge.

    ``embedder`` is a :class:`SpeakerEmbedder` (or anything with
    ``embed(list_of_waveforms) -> [N, E]``). With ``vad=True``, windows are
    placed only inside :func:`energy_vad` speech regions and the returned
    segments never cover silence.

    ``clustering``: ``"nmesc"`` (default, per-conversation auto-tuned
    spectral clustering) or ``"ahc"`` (average-linkage agglomerative with
    the dev-calibrated ``ahc_threshold`` stop —
    :func:`calibrate_ahc_threshold`; the JAX package's comparison of the
    two is docs/diarize_bench/DER.md).

    With ``overlap_threshold`` set, windows whose embedding sits between two
    cluster centroids additionally emit the runner-up speaker
    (:func:`overlap_assign`), so returned segments may overlap — calibrate
    both knobs on a dev set via :func:`calibrate_overlap_threshold`.
    """
    assert clustering in ("nmesc", "ahc"), clustering
    wav = np.asarray(waveform, np.float32).reshape(-1)
    win = int(window_s * sample_rate)
    hop = max(1, int(hop_s * sample_rate))

    def _window_starts(lo: int, hi: int) -> List[int]:
        if hi - lo <= win:
            return [lo]
        starts = list(range(lo, hi - win + 1, hop))
        if starts[-1] + win < hi:
            starts.append(hi - win)
        return starts

    if vad:
        regions = energy_vad(wav, sample_rate)
        if not regions:
            return []
        bounds = [
            (int(t0 * sample_rate), int(t1 * sample_rate)) for t0, t1 in regions
        ]
    else:
        bounds = [(0, len(wav))]
    starts, limits = [], []
    for lo, hi in bounds:
        for s in _window_starts(lo, hi):
            starts.append(s)
            limits.append(hi)
    windows = [wav[s:min(s + win, hi)] for s, hi in zip(starts, limits)]
    emb = np.asarray(embedder.embed(windows))
    if clustering == "ahc":
        labels = ahc_cluster(emb, ahc_threshold, max_speakers=max_speakers)
    else:
        labels = spectral_cluster(
            emb, n_speakers=n_speakers, max_speakers=max_speakers, seed=seed
        )
    sec = (
        overlap_assign(emb, labels, overlap_threshold, overlap_margin)
        if overlap_threshold is not None
        else np.full(len(starts), -1, np.int64)
    )
    # merge per speech region (no merging across silence)
    segments: List[Segment] = []
    for lo, hi in bounds:
        js = [j for j in range(len(starts)) if lo <= starts[j] < hi]
        if not js:
            continue
        t0 = [starts[j] / sample_rate for j in js]
        t1 = [min(starts[j] + win, hi) / sample_rate for j in js]
        labs = [labels[j] for j in js]
        segments.extend(merge_windows(labs, t0, t1))
        segments.extend(_secondary_segments(sec[js], labs, t0, t1))
    return segments


class OnlineDiarizer:
    """Streaming diarization: feed audio incrementally, get running
    segments with stable speaker ids (no lookahead; real-time serving).

    Greedy centroid assignment: each completed window embeds and joins the
    closest running speaker centroid when its cosine similarity clears
    ``threshold``, otherwise opens a new speaker (capped at
    ``max_speakers`` — then the closest centroid wins unconditionally).
    Centroids are running means of unit embeddings (re-normalized), so
    they adapt as a speaker accumulates evidence. Offline
    :func:`diarize` with NME-SC remains the quality reference; this trades
    global clustering for O(window) latency.
    """

    def __init__(
        self,
        embedder,
        sample_rate: int,
        window_s: float = 1.5,
        hop_s: float = 0.75,
        threshold: float = 0.6,
        max_speakers: int = 8,
    ):
        self.embedder = embedder
        self.sr = sample_rate
        self.win = int(window_s * sample_rate)
        self.hop = max(1, int(hop_s * sample_rate))
        self.threshold = threshold
        self.max_speakers = max_speakers
        self._buf = np.zeros(0, np.float32)
        self._consumed = 0  # samples already emitted as window starts
        self.centroids: List[np.ndarray] = []
        self._counts: List[int] = []
        self._labels: List[int] = []
        self._starts: List[int] = []

    def _assign(self, emb: np.ndarray) -> int:
        emb = emb / max(np.linalg.norm(emb), 1e-12)
        if not self.centroids:
            self.centroids.append(emb.copy())
            self._counts.append(1)
            return 0
        sims = np.array([float(c @ emb) for c in self.centroids])
        best = int(sims.argmax())
        if sims[best] < self.threshold and len(self.centroids) < self.max_speakers:
            self.centroids.append(emb.copy())
            self._counts.append(1)
            return len(self.centroids) - 1
        n = self._counts[best]
        c = (self.centroids[best] * n + emb) / (n + 1)
        self.centroids[best] = c / max(np.linalg.norm(c), 1e-12)
        self._counts[best] += 1
        return best

    def feed(self, chunk: np.ndarray) -> List[Segment]:
        """Append audio; embeds every window that completed and returns the
        updated running segment list (also available as ``segments``)."""
        self._buf = np.concatenate(
            [self._buf, np.asarray(chunk, np.float32).reshape(-1)]
        )
        windows, starts = [], []
        while self._consumed + self.win <= len(self._buf):
            windows.append(self._buf[self._consumed:self._consumed + self.win])
            starts.append(self._consumed)
            self._consumed += self.hop
        if windows:
            embs = np.asarray(self.embedder.embed(windows))
            for e, s in zip(embs, starts):
                self._labels.append(self._assign(e))
                self._starts.append(s)
        return self.segments

    @property
    def segments(self) -> List[Segment]:
        if not self._labels:
            return []
        t0 = [s / self.sr for s in self._starts]
        t1 = [(s + self.win) / self.sr for s in self._starts]
        return merge_windows(self._labels, t0, t1)

    def finish(self) -> List[Segment]:
        """Flush the tail (a final short window over the remaining audio)."""
        tail = len(self._buf) - self._consumed
        if tail >= self.hop:  # enough new audio to be worth a window
            w = self._buf[-self.win:] if len(self._buf) >= self.win else self._buf
            emb = np.asarray(self.embedder.embed([w]))[0]
            self._labels.append(self._assign(emb))
            self._starts.append(max(len(self._buf) - self.win, 0))
        return self.segments


def _activity_matrix(
    segments: Sequence[Tuple[float, float, int]], n: int, frame_s: float
) -> np.ndarray:
    """``[n_frames, n_speakers]`` boolean speaker-activity matrix (a frame
    may have several active speakers — overlapping segments stack)."""
    ids = sorted({int(spk) for _, _, spk in segments})
    idmap = {spk: i for i, spk in enumerate(ids)}
    act = np.zeros((n, len(ids)), bool)
    for s, e, spk in segments:
        act[int(s / frame_s):int(e / frame_s), idmap[int(spk)]] = True
    return act


def write_rttm(segments, file, uri: str = "audio", channel: int = 1) -> None:
    """Write segments as NIST RTTM ``SPEAKER`` lines — the diarization
    interchange format consumed by md-eval/dscore/pyannote:

    ``SPEAKER <uri> <chan> <tbeg> <tdur> <NA> <NA> <name> <NA> <NA>``

    Overlapping segments (``diarize(..., overlap_threshold=...)``) are
    naturally representable. ``file`` is a path or an open text handle
    (append-friendly so several uris can share one file)."""
    own = isinstance(file, (str, bytes))
    f = open(file, "a") if own else file
    try:
        for s, e, spk in segments:
            f.write(
                f"SPEAKER {uri} {channel} {s:.3f} {e - s:.3f} "
                f"<NA> <NA> spk{int(spk)} <NA> <NA>\n"
            )
    finally:
        if own:
            f.close()


def read_rttm(path: str):
    """Parse an RTTM file into ``{uri: [Segment, ...]}``. Speaker names of
    the form ``spk<int>`` map to that integer (round-trip with
    :func:`write_rttm`); any other names get sequential ids per uri in
    order of first appearance."""
    out: dict = {}
    name_ids: dict = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            uri, tbeg, tdur, name = parts[1], parts[3], parts[4], parts[7]
            ids = name_ids.setdefault(uri, {})
            if name not in ids:
                if name.startswith("spk") and name[3:].isdigit():
                    ids[name] = int(name[3:])
                else:
                    ids[name] = len(ids)
            out.setdefault(uri, []).append(
                Segment(float(tbeg), float(tbeg) + float(tdur), ids[name])
            )
    return out


def diarization_error_rate(
    reference: Sequence[Tuple[float, float, int]],
    hypothesis: Sequence[Tuple[float, float, int]],
    frame_s: float = 0.01,
) -> float:
    """Frame-based DER with optimal speaker mapping (Hungarian assignment)
    and full overlap support (NIST md-eval semantics).

    Both inputs are ``(start_s, end_s, speaker)`` triples (``Segment``
    iterates as one); segments of different speakers may overlap on either
    side. Per frame the error is ``max(N_ref, N_hyp) - N_correct`` under the
    optimal one-to-one speaker mapping, and
    ``DER = sum(error) / sum(N_ref)`` — the denominator is total reference
    *speaker time*, so an overlapped second speaker that goes undetected
    counts as miss. For single-speaker frames this reduces to the familiar
    ``(miss + false_alarm + confusion) / scored_speech``.
    """
    from scipy.optimize import linear_sum_assignment

    end = max([e for _, e, _ in reference] + [e for _, e, _ in hypothesis])
    n = int(np.ceil(end / frame_s))
    ref = _activity_matrix(reference, n, frame_s)  # [n, R]
    hyp = _activity_matrix(hypothesis, n, frame_s)  # [n, H]
    # pairwise co-activity time -> optimal speaker mapping
    overlap = (ref[:, :, None] & hyp[:, None, :]).sum(0)
    ri, hj = linear_sum_assignment(-overlap)
    correct = int((ref[:, ri] & hyp[:, hj]).sum())
    n_ref = ref.sum(1)
    n_hyp = hyp.sum(1)
    err = int(np.maximum(n_ref, n_hyp).sum()) - correct
    return float(err / max(int(n_ref.sum()), 1))
