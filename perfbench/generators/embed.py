"""Serving traffic: one client in a closed loop, each request one
``SpeakerEmbedder.embed`` call on a list of waveforms, the next sent when
the embeddings of the last are on the host.

A request is either a list of utterances (``kind: utterances``: lengths
from a log-normal law, the same quantiles in the same requests for every
seed, in an order the seed draws) or one recording cut into the diarizer's windows
(``kind: recording``: lengths evenly spaced from ``min_s`` to ``max_s``;
windows of ``window_s`` every ``hop_s``, the last ending at the
recording's end). A pool of ``pool`` distinct requests is made in set-up
from the seed and sent in turn.

The embedder gets the mix's serving settings (buckets, batch size, window
overlap; the buckets and the overlap are the embedder's defaults, as the
CLI's commands use them): padding changes what the convolutions see near
an utterance's end, so the reference pads by the same rule.

The model's weights are drawn from the seed; its BatchNorm running
statistics are the batch statistics of the plain reference in training
mode over a calibration batch of the same voices, so that every layer
sees inputs of unit scale, as in a trained model. Set-up captures the
buckets the pool uses, largest first, and nothing else.

The check: after the window, a sample of the answers drawn from the seed,
with the pool's longest utterance in it, against the plain reference
(``perfbench/reference/embed.py``) on the same waveforms.
"""

from __future__ import annotations

import gc
import math
import time
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch

from perfbench.core import program
from perfbench.core import trace as tr_
from perfbench.core.bench import against, checks_of, derive
from perfbench.core.weights import draw_weights, synth
from perfbench.reference import titanet as ref_titanet
from perfbench.reference.embed import bucket_for, embed_utterances, geometric_buckets, window_lengths
from perfbench.reference.frontend import log_mel


def _lognormal_lengths(req: dict, n: int) -> np.ndarray:
    """``n`` quantiles of a log-normal law with ``sigma``, truncated to
    ``[min_s, max_s]``, whose mean is ``mean_s``: the median is found by
    bisection."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])

    def grid(mu):
        return np.clip(np.exp(mu + req["sigma"] * z), req["min_s"], req["max_s"])

    lo, hi = math.log(req["min_s"]), math.log(req["max_s"])
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if grid(mid).mean() < req["mean_s"] else (lo, mid)
    return grid(0.5 * (lo + hi))


def request_plan(traffic: dict, seed: int, sample_rate: int) -> List[np.ndarray]:
    """The pool's requests, each the lengths (samples) of its waveforms
    before windowing. Every seed gets the same requests' lengths: request
    ``j`` of utterances holds every ``pool``-th quantile from the ``j``-th,
    so the requests are alike and the work a request asks for does not
    hang on the seed; the seed orders the requests and each one's
    utterances."""
    req, pool = traffic["request"], traffic["pool"]
    rng = np.random.default_rng(derive(seed, "requests"))
    order = rng.permutation(pool)
    if req["kind"] == "utterances":
        grid = np.round(_lognormal_lengths(req, pool * req["count"]) * sample_rate).astype(np.int64)
        return [rng.permutation(grid[j::pool]) for j in order]
    secs = np.linspace(req["min_s"], req["max_s"], pool)[order]
    return [np.array([int(round(s * sample_rate))], np.int64) for s in secs]


def diarizer_windows(n: int, win: int, hop: int) -> List[tuple]:
    """``(start, length)`` of the windows of a recording of ``n`` samples:
    every ``hop`` samples, the last one ending at the end."""
    if n <= win:
        return [(0, n)]
    starts = list(range(0, n - win + 1, hop))
    if starts[-1] + win < n:
        starts.append(n - win)
    return [(s, win) for s in starts]


def make_pool(traffic: dict, seed: int, device, sample_rate: int):
    """``(requests, audio seconds of each)``: the pool's requests as lists
    of float32 waveforms on the host; a recording is worth its length, not
    the sum of its overlapping windows."""
    req = traffic["request"]
    plan = request_plan(traffic, seed, sample_rate)
    rng = np.random.default_rng(derive(seed, "voices"))
    n_voices = req.get("speakers", 1000)
    pool, seconds = [], []
    for k, lengths in enumerate(plan):
        if req["kind"] == "utterances":
            segs, spk = lengths, rng.integers(0, n_voices, len(lengths))
        else:
            # a conversation: turns of 1-4 s, two speakers taking them in turn
            total, segs = int(lengths[0]), []
            while sum(segs) < total:
                segs.append(min(int(rng.uniform(1.0, 4.0) * sample_rate), total - sum(segs)))
            pair = rng.choice(n_voices, 2, replace=False)
            segs, spk = np.asarray(segs, np.int64), pair[np.arange(len(segs)) % 2]
        audio = synth(segs, spk, n_voices, derive(seed, f"audio-{k}"), device).cpu().numpy()
        seconds.append(len(audio) / sample_rate)
        if req["kind"] == "utterances":
            pool.append(np.split(audio, np.cumsum(lengths)[:-1]))
        else:
            win, hop = int(req["window_s"] * sample_rate), int(req["hop_s"] * sample_rate)
            pool.append([audio[s:s + n] for s, n in diarizer_windows(len(audio), win, hop)])
    return pool, seconds


def calibrate(weights: dict, cfg: dict, traffic: dict, seed: int, device) -> None:
    """Set each BatchNorm's running statistics to its batch statistics in
    the plain reference over a calibration batch (in place)."""
    cal = traffic["calibration"]
    sr = cfg["frontend"]["sample_rate"]
    n = int(cal["seconds"] * sr)
    rng = np.random.default_rng(derive(seed, "calibration"))
    wav = synth(np.full(cal["rows"], n), rng.integers(0, 1000, cal["rows"]), 1000,
                derive(seed, "calibration-audio"), device).view(cal["rows"], n)
    stats = {}
    with torch.no_grad():
        mel, _ = log_mel(wav, cfg["frontend"])
        ref_titanet.Net(weights, cfg, train=True, calib=stats)(mel)
    for name, (mean, var) in stats.items():
        weights[f"{name}.running_mean"] = mean
        weights[f"{name}.running_var"] = var


class Serving:
    """The program's embedder over the pool, with the requests it answered."""

    def __init__(self, cell, seed: int, device, quantized: bool = False):
        from titanet_torch.train.extractor import SpeakerEmbedder

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.device, self.seed = cfg, tr, device, seed
        sr = cfg["frontend"]["sample_rate"]
        self.weights = draw_weights(ref_titanet.param_spec(cfg), derive(seed, "weights"), device)
        calibrate(self.weights, cfg, tr, seed, device)
        self.model = program.titanet(cfg, self.weights, device)
        self.embedder = SpeakerEmbedder(self.model, program.frontend(cfg),
                                        buckets=geometric_buckets(**tr["buckets"]), batch_size=tr["batch_size"],
                                        window_overlap=tr["window_overlap"], device=device, quantized=quantized)
        self.buckets, self.overlap = list(self.embedder.buckets), self.embedder.window_overlap
        self.pool, self.audio_s = make_pool(tr, seed, device, sr)
        self.outputs: List[np.ndarray] = []
        self.latency_s: List[float] = []
        self.calls: List[tuple] = []  # (rows, samples) of each embedding batch the embedder launched
        self.computed: List[int] = []  # samples the embedder computed for each request

    def warm(self) -> None:
        """Capture every bucket the pool's windows use, largest first."""
        buckets = self.buckets
        used = set()
        for req in self.pool:
            for w in req:
                for _, n in window_lengths(len(w), buckets, self.overlap):
                    used.add(bucket_for(n, buckets))
        for b in sorted(used, reverse=True):
            self.embedder.embed([np.zeros(b, np.float32)])

    def request(self, k: int) -> None:
        req = self.pool[k % len(self.pool)]
        mark = len(self.calls)
        t0 = time.perf_counter()
        with tr_.span("request"):
            out = self.embedder.embed(req)
        self.latency_s.append(time.perf_counter() - t0)
        self.outputs.append(out)
        self.computed.append(sum(rows * samples for rows, samples in self.calls[mark:]))

    def counting(self):
        """Record the shape of every batch the embedder hands its step
        (the program's own launches, read from their arguments)."""
        from titanet_torch.train import extractor

        def record(model, wav, *args, **kwargs):
            self.calls.append(tuple(wav.shape))

        return tr_.wrapped(extractor, "embed_step", on_call=record)

    def sample(self, n: int) -> List[tuple]:
        """``(answered request, waveform)`` pairs drawn from the seed, with
        the pool's longest waveform where a request holding it was answered."""
        rng = np.random.default_rng(derive(self.seed, "sample"))
        done = len(self.outputs)
        picks = {(int(k), int(rng.integers(0, len(self.pool[k % len(self.pool)]))))
                 for k in rng.integers(0, done, n)}
        longest = max(((k, i) for k in range(min(done, len(self.pool)))
                       for i in range(len(self.pool[k]))), key=lambda ki: len(self.pool[ki[0]][ki[1]]))
        picks.add(longest)
        return sorted(picks)

    def references(self, picks: List[tuple], names=("f32", "stated")) -> Dict[str, np.ndarray]:
        """The plain reference's unit embeddings of the picked waveforms,
        in float32 (``f32``) and in the configuration's compute dtype
        (``stated``), those of ``names``."""
        waves = [self.pool[k % len(self.pool)][i] for k, i in picks]
        buckets = geometric_buckets(**self.tr["buckets"])
        out = {}
        for name, dtype in (("f32", torch.float32), ("stated", getattr(torch, self.cfg["compute_dtype"]))):
            if name in names:
                out[name] = embed_utterances(self.weights, self.cfg, waves, buckets, self.tr["window_overlap"],
                                         self.device, self.tr["batch_size"], dtype=dtype)
        return out

    @staticmethod
    def numbers(picks: List[tuple], answers: List[np.ndarray], refs: Dict[str, np.ndarray]) -> Dict[str, float]:
        """What a serving check can compare: the largest and the median
        distance between a picked answer and the reference's unit
        embedding, against each reference (``f32_``, ``stated_``)."""
        got = np.stack([answers[k][i] for k, i in picks])

        def gaps(_, ref):
            d = np.linalg.norm(got - ref, axis=-1)
            return {"gap_max": float(d.max()), "gap_median": float(np.median(d))}

        return against(refs, None, gaps)

def run(cell, ctx):
    tr = cell.traffic
    serving = Serving(cell, ctx.seed, ctx.device)
    serving.warm()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    with serving.counting():
        t0 = time.perf_counter()
        k, audio = 0, 0.0
        while True:
            serving.request(k)
            audio += serving.audio_s[k % len(serving.pool)]
            k += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    failed = sum(int(not np.isfinite(o).all()) for o in serving.outputs)
    lat_ms = 1e3 * np.asarray(serving.latency_s)

    trace = None
    if ctx.trace:
        from titanet_torch.train import extractor

        answered = len(serving.outputs)
        trace_calls = []

        def section():
            mark = len(serving.calls)
            for j in range(tr["trace_requests"]):
                serving.request(answered + j)
            trace_calls[:] = serving.calls[mark:]  # the read cycle's, the last
            return tr["trace_requests"]

        with serving.counting(), tr_.wrapped(extractor, "embed_step", "embed_step"):
            trace = tr_.traced(section, ctx.device)
        del serving.outputs[answered:], serving.latency_s[answered:], serving.computed[answered:]

    picks = serving.sample(tr["check"]["answers"])
    answers = serving.outputs
    del serving.model, serving.embedder
    gc.collect()
    from titanet_torch.train.capture import GRAPHS

    GRAPHS._collect_dead()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with ctx.reference_precision():
        refs = serving.references(picks, {k.split("_", 1)[0] for k in cell.limits})
        checks = checks_of(serving.numbers(picks, answers, refs), cell.limits)

    sr = cell.config["frontend"]["sample_rate"]
    counts = {"kind": "embed", "window_s": window_s, "requests": k, "audio_s": audio,
              "waveforms": [[len(w) for w in serving.pool[j % len(serving.pool)]] for j in range(k)],
              "computed_samples": serving.computed[:k],
              "buckets": serving.buckets, "batch_size": tr["batch_size"],
              "window_overlap": serving.overlap, "hop": cell.config["frontend"]["hop_length"],
              "sample_rate": sr, "latency_ms": lat_ms.tolist()}
    if trace is not None:
        counts["trace_calls"] = trace_calls
    return dict(attempted=k, failed=failed, setup_s=setup_s,
                e2e={"embed_audio_s_per_s": audio / window_s},
                counts=counts, trace=trace, checks=checks, memory_peak_bytes=peak, devices=1)
