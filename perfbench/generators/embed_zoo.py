"""Serving traffic for a model of the port's zoo: the closed-loop client of
:mod:`perfbench.generators.embed` (its pool of requests, its counting of
the embedder's batches, its sample of answers and its numbers) around a
model other than TitaNet.

What names the model is here: the model built on the meta device and filled
with the weights drawn from the seed (scaled by the configuration's
``init_gain``, a layer's gain over the U(+-1/sqrt(fan_in)) bound), the
BatchNorm statistics calibrated in
the plain reference in training mode, and the reference the answers are
checked against. The configuration's ``model`` names it: ``ecapa_tdnn``
(``titanet_torch.models.ecapa.EcapaTdnn``, :mod:`perfbench.reference.ecapa`).

Besides the shape of every batch the embedder hands ``embed_step``, the
client records the batch's ``lengths`` (samples a row), read from the same
arguments, for the per-layer readers that count a row's valid frames; the
launches of the pooling kernels in the window (the wrappers' counters,
replay-aware); and, over set-up and window, the calls of the model's plain
``attentive_stats``. The last two are printed on standard error.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.core import program
from perfbench.core import trace as tr_
from perfbench.core.bench import checks_of, derive
from perfbench.core.weights import draw_weights, synth
from perfbench.generators.embed import Serving, make_pool
from perfbench.reference import ecapa as ref_ecapa
from perfbench.reference.embed import geometric_buckets
from perfbench.reference.frontend import log_mel

REFERENCES = {"ecapa_tdnn": ref_ecapa}


def reference(cfg: dict):
    """The plain reference module of the configuration's ``model``."""
    if cfg.get("model") not in REFERENCES:
        raise SystemExit(f"embed_zoo serves {sorted(REFERENCES)}; the configuration names {cfg.get('model')!r}")
    return REFERENCES[cfg["model"]]


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The program's model of ``cfg`` on ``device`` holding ``weights``
    (parameters and BatchNorm running statistics)."""
    from titanet_torch.models.ecapa import EcapaTdnn

    ref = reference(cfg)
    with torch.device("meta"):
        model = EcapaTdnn(
            n_mels=cfg["frontend"]["n_mels"], channels=cfg["channels"], mfa_channels=cfg["mfa_channels"],
            embedding_size=cfg["embedding_size"], kernel_size=cfg["kernel_size"],
            dilations=tuple(cfg["dilations"]), scale=cfg["scale"], se_bottleneck=cfg["se_bottleneck"],
            attention_hidden_size=cfg["attention_hidden_size"], prolog_kernel_size=cfg["prolog_kernel_size"],
            dtype=getattr(torch, cfg["compute_dtype"]),
        )
    model.to_empty(device=device)
    sd = {n: weights[n] for n, *_ in ref.param_spec(cfg)}
    for name, _ in ref.norm_sites(cfg):
        sd[f"{name}.running_mean"] = weights[f"{name}.running_mean"]
        sd[f"{name}.running_var"] = weights[f"{name}.running_var"]
    model.load_state_dict(sd, strict=True)
    return model.eval()


def calibrate(weights: dict, cfg: dict, traffic: dict, seed: int, device) -> None:
    """Each BatchNorm's running statistics := its batch statistics in the
    plain reference over a calibration batch (in place), as
    :func:`perfbench.generators.embed.calibrate` sets TitaNet's."""
    cal = traffic["calibration"]
    sr = cfg["frontend"]["sample_rate"]
    n = int(cal["seconds"] * sr)
    rng = np.random.default_rng(derive(seed, "calibration"))
    wav = synth(np.full(cal["rows"], n), rng.integers(0, 1000, cal["rows"]), 1000,
                derive(seed, "calibration-audio"), device).view(cal["rows"], n)
    stats = {}
    with torch.no_grad():
        mel, _ = log_mel(wav, cfg["frontend"])
        reference(cfg).Net(weights, cfg, train=True, calib=stats)(mel)
    for name, (mean, var) in stats.items():
        weights[f"{name}.running_mean"] = mean
        weights[f"{name}.running_var"] = var


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference's parameters drawn from the seed
    (:func:`perfbench.core.weights.draw_weights`), each one that the
    configuration's ``init_gain`` names scaled by its gain."""
    weights = draw_weights(reference(cfg).param_spec(cfg), derive(seed, "weights"), device)
    for name, gain in cfg.get("init_gain", {}).items():
        weights[name].mul_(gain)
    return weights


def launches() -> Dict[str, int]:
    """The port's launch counters of the pooling kernels (absent in a
    program without them)."""
    from titanet_torch.ops.kernels import pool

    return {name: getattr(getattr(pool, name, None), "launches", 0)
            for name in ("context_stats", "attentive_pool_fwd")}


class ZooServing(Serving):
    """:class:`~perfbench.generators.embed.Serving` on a zoo model."""

    def __init__(self, cell, seed: int, device):
        from titanet_torch.train.extractor import SpeakerEmbedder

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.device, self.seed = cfg, tr, device, seed
        sr = cfg["frontend"]["sample_rate"]
        self.weights = draw(cfg, seed, device)
        calibrate(self.weights, cfg, tr, seed, device)
        self.model = build_model(cfg, self.weights, device)
        self.embedder = SpeakerEmbedder(self.model, program.frontend(cfg),
                                        buckets=geometric_buckets(**tr["buckets"]), batch_size=tr["batch_size"],
                                        window_overlap=tr["window_overlap"], device=device)
        self.buckets, self.overlap = list(self.embedder.buckets), self.embedder.window_overlap
        self.pool, self.audio_s = make_pool(tr, seed, device, sr)
        self.outputs: List[np.ndarray] = []
        self.latency_s: List[float] = []
        self.calls: List[tuple] = []  # (rows, samples) of each embedding batch the embedder launched
        self.lengths: List[np.ndarray] = []  # the lengths (samples a row) of each of those batches
        self.computed: List[int] = []
        self.plain_pools = 0  # calls of the model's plain attentive statistics

    def counting(self):
        """Record the shape and the lengths of every batch the embedder
        hands its step."""
        from titanet_torch.train import extractor

        def record(model, wav, lengths, *args, **kwargs):
            self.calls.append(tuple(wav.shape))
            self.lengths.append(np.array(lengths.cpu() if torch.is_tensor(lengths) else lengths, np.int64))

        return tr_.wrapped(extractor, "embed_step", on_call=record)

    def plain_pooling(self):
        """Count the calls of the model's plain attentive statistics (the
        route a program without the pooling kernel takes)."""
        from titanet_torch.models import ecapa

        def count(*args, **kwargs):
            self.plain_pools += 1

        return tr_.wrapped(ecapa, "attentive_stats", on_call=count)

    def references(self, picks: List[tuple], names=("f32", "stated"), **kw) -> Dict[str, np.ndarray]:
        """The plain reference's unit embeddings of the picked waveforms in
        float32 (``f32``) and in the compute dtype (``stated``); ``kw``
        (``rnd``, ``act``, ``fault``) goes to the reference."""
        waves = [self.pool[k % len(self.pool)][i] for k, i in picks]
        buckets = geometric_buckets(**self.tr["buckets"])
        out = {}
        for name, dtype in (("f32", torch.float32), ("stated", getattr(torch, self.cfg["compute_dtype"]))):
            if name in names:
                out[name] = reference(self.cfg).embed_utterances(
                    self.weights, self.cfg, waves, buckets, self.tr["window_overlap"], self.device,
                    self.tr["batch_size"], dtype=dtype, **kw)
        return out


def run(cell, ctx):
    tr = cell.traffic
    serving = ZooServing(cell, ctx.seed, ctx.device)
    with serving.plain_pooling():
        serving.warm()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        setup_s = time.perf_counter() - ctx.t_start

        before = launches()
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
        after = launches()
    batches = len(serving.calls)
    route = {name: after[name] - before[name] for name in after}
    print(f"perfbench embed_zoo: {batches} batches in the window, launches there {route}; "
          f"plain attentive_stats calls over set-up and window {serving.plain_pools}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    failed = sum(int(not np.isfinite(o).all()) for o in serving.outputs)
    lat_ms = 1e3 * np.asarray(serving.latency_s)

    trace = None
    if ctx.trace:
        from titanet_torch.train import extractor

        answered = len(serving.outputs)
        trace_calls, trace_lengths = [], []

        def section():
            mark = len(serving.calls)
            for j in range(tr["trace_requests"]):
                serving.request(answered + j)
            trace_calls[:] = serving.calls[mark:]  # the read cycle's, the last
            trace_lengths[:] = serving.lengths[mark:]
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
              "sample_rate": sr, "latency_ms": lat_ms.tolist(),
              "window_batches": batches, "route_launches": route, "plain_pools": serving.plain_pools}
    if trace is not None:
        counts["trace_calls"] = trace_calls
        counts["trace_lengths"] = [x.tolist() for x in trace_lengths]
    return dict(attempted=k, failed=failed, setup_s=setup_s,
                e2e={"embed_audio_s_per_s": audio / window_s},
                counts=counts, trace=trace, checks=checks, memory_peak_bytes=peak, devices=1)
