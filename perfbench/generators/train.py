"""Training traffic: the trainer's step on crops of a corpus held on the
device, back to back, on one rank or on P ranks of one host.

The corpus is made from the seed on each rank's device as one int16
tensor (``titanet_torch.data.device_corpus.DeviceCorpus``): its utterance
lengths are the same for every seed (the quantiles of a normal law
clipped to ``[min_s, max_s]``), the seed deals them speakers and voices.
Each step draws its global batch of crops on the host from the seed (an
utterance at least one crop long, a start inside it), and the trainer's
feed (``device_prefetch`` over ``DeviceBatch`` descriptors) gathers each
rank's rows on its device; the rank runs ``train_step`` on them and folds
the loss into the epoch's device accumulator, as ``train_one_epoch`` does.

Set-up builds the state once, runs the first ``check_steps`` steps through
that same feed and call (the first captures the step's graph) and keeps
what the check needs: each step's loss, the first gradient as Adam holds
it after step 1, and each leaf's change over the steps. The window then
continues the same state. After it, the plain reference
(``perfbench/reference/train.py``) repeats the check steps from the same
weights, rows and dropout seed on rank 0's device.

With ``ranks`` P > 1, this process is rank 0 and starts the others; the
ranks join one NCCL group (gloo on the CPU) and a gloo group of their own
that carries rank 0's decision to end the window, so every rank runs the
same steps. With ``--trace 1`` every rank traces the same steps and
hands its whole trace to rank 0 (``counts["trace_ranks"]``, one
:class:`~perfbench.core.trace.Trace` a rank).
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch

from perfbench.core import program
from perfbench.core import trace as tr_
from perfbench.core.bench import Checks, against, checks_of, derive, train_numbers
from perfbench.core.weights import draw_weights, synth
from perfbench.reference import titanet as ref_titanet
from perfbench.reference.train import HEAD, train_steps

TAIL_PAD = 400_000  # zeros after the last utterance, as the program's corpus layout keeps


def corpus_plan(corpus: dict, seed: int):
    """``(lengths [N] int64 samples, speakers [N] int32)``: fixed lengths,
    dealt in an order and to speakers drawn from ``seed``."""
    n, sr = corpus["utterances"], corpus["sample_rate"]
    law = NormalDist(corpus["mean_s"], corpus["sd_s"])
    secs = np.clip([law.inv_cdf((i + 0.5) / n) for i in range(n)], corpus["min_s"], corpus["max_s"])
    rng = np.random.default_rng(derive(seed, "corpus-plan"))
    lengths = (secs[rng.permutation(n)] * sr).astype(np.int64)
    speakers = rng.permutation(np.arange(n) % corpus["speakers"]).astype(np.int32)
    return lengths, speakers


def make_corpus(traffic: dict, seed: int, device):
    from titanet_torch.data.device_corpus import DeviceCorpus

    c = traffic["corpus"]
    lengths, speakers = corpus_plan(c, seed)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    total = int(lengths.sum())
    flat = torch.zeros(total + TAIL_PAD, dtype=torch.int16, device=device)
    # voiced in slices of utterances, each quantized to int16 PCM as it comes
    step = 512
    for a in range(0, len(lengths), step):
        b = min(a + step, len(lengths))
        wav = synth(lengths[a:b], speakers[a:b], c["speakers"], derive(seed, f"corpus-{a}"), device)
        pcm = (wav * 32768.0).clamp_(-32768.0, 32767.0).to(torch.int16)
        flat[offsets[a]:offsets[a] + pcm.numel()] = pcm
    return DeviceCorpus(flat, offsets, lengths.astype(np.int32), speakers, c["sample_rate"])


class Crops:
    """The global batch of each step, drawn on the host from the seed."""

    def __init__(self, corpus, traffic: dict, seed: int):
        self.corpus = corpus
        self.width = int(traffic["crop_s"] * traffic["corpus"]["sample_rate"])
        self.rows = traffic["rows_per_rank"] * traffic["ranks"]
        self.eligible = np.flatnonzero(corpus.lengths >= self.width)
        self.rng = np.random.default_rng(derive(seed, "crops"))

    def next(self):
        """``(starts [G], speakers [G])`` of the next global batch."""
        u = self.eligible[self.rng.integers(0, len(self.eligible), self.rows)]
        room = self.corpus.lengths[u].astype(np.int64) - self.width + 1
        starts = self.corpus.offsets[u] + (self.rng.random(self.rows) * room).astype(np.int64)
        return starts, self.corpus.speaker_ids[u]


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tensors.items()}


class Rank:
    """One rank's program: state, feed and step."""

    def __init__(self, cell, seed: int, device, mesh):
        from titanet_torch.data.device_corpus import DeviceBatch
        from titanet_torch.data.loader import device_prefetch
        from titanet_torch.losses.heads import make_arcface
        from titanet_torch.train.state import create_train_state, init_metrics_acc, make_optimizer

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.device, self.mesh = cfg, tr, device, mesh
        n_classes = tr["corpus"]["speakers"]
        spec = ref_titanet.param_spec(cfg) + [(HEAD, (cfg["embedding_size"], n_classes), "uniform",
                                               cfg["embedding_size"])]
        self.weights = draw_weights(spec, derive(seed, "weights"), device)
        model = program.titanet(cfg, self.weights, device, dropout=tr["dropout"])
        with torch.device("meta"):
            head = make_arcface(n_classes, cfg["embedding_size"], scale=tr["loss"]["scale"],
                                margin=tr["loss"]["margin"])
        head.to_empty(device=device)
        head.load_state_dict({"weight": self.weights[HEAD]}, strict=True)
        opt = make_optimizer(tr["optimizer"]["name"], start_lr=tr["optimizer"]["lr"])
        self.dropout_seed = derive(seed, "dropout")
        self.state = create_train_state(model, head, opt, seed=self.dropout_seed)
        self.names = [n for n, _ in model.named_parameters()] + [HEAD]
        self.frontend = program.frontend(cfg)
        self.corpus = make_corpus(tr, seed, device)
        self.crops = Crops(self.corpus, tr, seed)
        self.acc = init_metrics_acc(n_classes, device=device)
        self.plans: List[tuple] = []  # the global batches of the check steps
        rank = 0 if mesh is None else mesh.rank
        per = tr["rows_per_rank"]

        def descriptors():
            while True:
                starts, spk = self.crops.next()
                if len(self.plans) < tr["check_steps"]:
                    self.plans.append((starts, spk))
                rows = slice(rank * per, (rank + 1) * per)
                yield DeviceBatch(self.corpus, starts[rows], np.full(per, self.crops.width, np.int32),
                                  spk[rows], self.crops.width)

        self.feed = device_prefetch(descriptors(), device=device, size=2)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.state.params()))

    def step(self):
        from titanet_torch.train.state import accumulate_metrics, train_step

        tensors, _ = next(self.feed)
        spk = tensors["speaker_ids"]
        with tr_.span("train_step"):
            self.state, m = train_step(self.state, tensors["waveform"], None, spk, frontend=self.frontend,
                                       renorm_head=True, mesh=self.mesh)
        self.last = m
        with tr_.span("metrics"):
            accumulate_metrics(self.acc, m["loss"], m["preds"], spk)
        return m["loss"]

    def check_steps(self) -> dict:
        """The first steps, with what the check reads of them."""
        from titanet_torch.train.state import ADAM_B1

        start = {n: t.detach().clone() for n, t in self.params().items()}
        losses = [self.step()]
        emb1 = self.last["embeddings"].float().cpu().numpy()
        grad1 = {n: float(torch.linalg.vector_norm(m.float())) / (1.0 - ADAM_B1)
                 for n, m in zip(self.names, self.state.opt_state.mu)}
        for _ in range(self.tr["check_steps"] - 1):
            losses.append(self.step())
        delta = _leaf_norms({n: t.detach() - start[n] for n, t in self.params().items()})
        rank = 0 if self.mesh is None else self.mesh.rank
        rows = (rank * len(emb1), (rank + 1) * len(emb1))
        return {"losses": [float(x) for x in losses], "grad1": grad1, "delta": delta, "emb1": emb1, "rows": rows}

    def check_batches(self) -> List[tuple]:
        """The check steps' global batches, gathered from this rank's corpus."""
        from titanet_torch.data.device_corpus import gather_windows

        out = []
        for starts, spk in self.plans:
            wav = gather_windows(self.corpus, starts, np.full(len(starts), self.crops.width), self.crops.width)
            out.append((wav, torch.as_tensor(spk, device=self.device).long()))
        return out


def _spawn_ranks(ctx) -> List[subprocess.Popen]:
    procs = []
    for r in range(1, ctx.world):
        cmd = [sys.executable, os.path.join(ctx.perfbench, "run.py"), *ctx.argv, "--rank", str(r),
               "--port", str(ctx.port)]
        # the ranks write to this process's standard error: its standard output carries the result alone
        procs.append(subprocess.Popen(cmd, stdout=2, env=ctx.env))
    return procs


def _group(ctx):
    import torch.distributed as dist

    backend = "nccl" if ctx.device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{ctx.port}", rank=ctx.rank,
                            world_size=ctx.world)
    return dist.new_group(backend="gloo")


def run(cell, ctx):
    """One run of a training cell: returns the outcome on rank 0, None on
    the others."""
    import torch.distributed as dist

    from titanet_torch.parallel import distributed as pd
    from titanet_torch.parallel.mesh import make_mesh

    tr = cell.traffic
    procs = _spawn_ranks(ctx) if ctx.rank == 0 and ctx.world > 1 else []
    try:
        mesh = control = None
        if ctx.world > 1:
            control = _group(ctx)
            mesh = make_mesh(ctx.world, device=ctx.device)
        rank = Rank(cell, ctx.seed, ctx.device, mesh)
        readings = rank.check_steps()
        batches = rank.check_batches() if ctx.rank == 0 else None
        _sync(ctx, control)
        setup_s = time.perf_counter() - ctx.t_start

        flag = torch.zeros(1)
        t0 = time.perf_counter()
        losses, steps = [], 0
        while True:
            losses.append(rank.step())
            steps += 1
            flag[0] = float(time.perf_counter() - t0 >= ctx.seconds)
            if control is not None:
                dist.broadcast(flag, 0, group=control)
            if flag[0] > 0:
                break
        _sync(ctx, control)
        window_s = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

        trace = None
        if ctx.trace:
            def section():
                for _ in range(tr["trace_steps"]):
                    with tr_.span("step"):
                        rank.step()
                return tr["trace_steps"]

            trace = tr_.traced(section, ctx.device)

        # each rank's whole trace goes to rank 0: the metrics' readers choose what to read in it
        mine = {"readings": readings, "peak": peak, "trace": trace}
        everyone = [mine]
        weights = {n: rank.weights[n] for n in rank.names}
        del rank
        if ctx.world > 1:
            everyone = [None] * ctx.world
            dist.all_gather_object(everyone, mine, group=control)
            gc.collect()
            pd.destroy_process_group()
        if ctx.rank != 0:
            return None

        _free_program(ctx)
        checks = _check(cell, ctx, everyone, weights, batches)
        for p in procs:
            _wait(p)
        procs = []
        rows = tr["rows_per_rank"] * ctx.world
        counts = {"kind": "train", "window_s": window_s, "steps": steps, "rows_per_step": rows,
                  "ranks": ctx.world, "crop_samples": int(tr["crop_s"] * tr["corpus"]["sample_rate"])}
        if trace is not None:
            counts["trace_ranks"] = [e["trace"] for e in everyone]
        return dict(attempted=steps, failed=failed, setup_s=setup_s,
                    e2e={"train_utt_per_s": steps * rows / window_s},
                    counts=counts, trace=trace, checks=checks,
                    memory_peak_bytes=max(e["peak"] for e in everyone), devices=ctx.world)
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _sync(ctx, control) -> None:
    import torch.distributed as dist

    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    if control is not None:
        dist.barrier(group=control)


def _wait(p: subprocess.Popen) -> None:
    if p.wait(timeout=120) != 0:
        raise RuntimeError(f"a rank exited with {p.returncode}")


def _free_program(ctx) -> None:
    from titanet_torch.train.capture import GRAPHS

    gc.collect()
    GRAPHS._collect_dead()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def references(cell, weights, batches, dropout_seed: int, names=("f32", "stated"), **kw) -> Dict[str, dict]:
    """The reference's check steps in float32 (``f32``) and in the
    configuration's compute dtype (``stated``), those of ``names``; ``kw``
    as :func:`~perfbench.reference.train.train_steps` takes it."""
    cfg, tr = cell.config, cell.traffic
    return {name: train_steps(weights, batches, cfg, tr, dropout_seed, dtype=dtype, **kw)
            for name, dtype in (("f32", torch.float32), ("stated", getattr(torch, cfg["compute_dtype"])))
            if name in names}


def _check(cell, ctx, everyone, weights, batches) -> Checks:
    """Every rank's numbers against the references'; the worst rank's."""
    with ctx.reference_precision():
        refs = references(cell, weights, batches, derive(ctx.seed, "dropout"),
                          {k.split("_", 1)[0] for k in cell.limits})
    per_rank = [against(refs, e["readings"], train_numbers) for e in everyone]
    return checks_of({k: max(n[k] for n in per_rank) for k in per_rank[0]}, cell.limits)
