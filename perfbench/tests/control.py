"""The readings that a cell's limits are set from: on each seed, the
numbers the check compares for the program (the lower reading), for the
control (the plain reference in a lower precision, or the program's own
lower-precision path where it has one) and for the faults a training cell
can have (read with the fault planted in the reference). Run on the card
at the cell's own sizes by ``test_perfbench_control.py``."""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from perfbench.core.bench import against, derive, moving_leaves, train_numbers
from perfbench.generators import embed as embed_gen
from perfbench.generators import train as train_gen
from perfbench.reference.lowp import fp8
from perfbench.reference.train import train_steps


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _free():
    from titanet_torch.train.capture import GRAPHS

    gc.collect()
    GRAPHS._collect_dead()
    torch.cuda.empty_cache()


def train_readings(cell, seed: int, device, program: bool = True) -> Dict[str, dict]:
    """``{"program": numbers, "control_fp8": ..., "half_batch": ...,
    ("no_exchange": ...)}``. Without ``program`` (a multi-rank cell read on
    one card) the global batches come from the seed's plan alone and only
    the reference's readings are taken."""
    tr = cell.traffic
    out = {}
    if program:
        rank = train_gen.Rank(cell, seed, device, None)
        readings = rank.check_steps()
        batches = rank.check_batches()
        weights = {n: rank.weights[n] for n in rank.names}
        del rank
        _free()
    else:
        from titanet_torch.data.device_corpus import gather_windows

        corpus = train_gen.make_corpus(tr, seed, device)
        crops = train_gen.Crops(corpus, tr, seed)
        batches = []
        for _ in range(tr["check_steps"]):
            starts, spk = crops.next()
            wav = gather_windows(corpus, starts, np.full(len(starts), crops.width), crops.width)
            batches.append((wav, torch.as_tensor(spk, device=device).long()))
        del corpus
        spec = train_gen.ref_titanet.param_spec(cell.config) + [
            (train_gen.HEAD, (cell.config["embedding_size"], tr["corpus"]["speakers"]), "uniform",
             cell.config["embedding_size"])]
        weights = train_gen.draw_weights(spec, derive(seed, "weights"), device)
    _no_tf32()
    dseed = derive(seed, "dropout")
    cfg, stated = cell.config, getattr(torch, cell.config["compute_dtype"])
    refs = train_gen.references(cell, weights, batches, dseed)
    if program:
        out["program"] = against(refs, readings, train_numbers)
        keep = moving_leaves(refs["stated"]["grad1"])
        ref = refs["stated"]
        worst = {k: max(keep, key=lambda n: abs(readings[k][n] - ref[k][n]) / ref[k][n]) for k in ("grad1", "delta")}
        out["look"] = {"losses": readings["losses"], "stated_losses": ref["losses"],
                       "f32_losses": refs["f32"]["losses"], "moving": len(keep), "leaves": len(ref["grad1"]),
                       **{f"worst_{k}": [n, readings[k][n], ref[k][n]] for k, n in worst.items()}}
    planted = {"control_fp8": dict(rnd=fp8, act=fp8), "half_batch": dict(fault="half_batch")}
    if tr["ranks"] > 1:
        planted["no_exchange"] = dict(fault="no_exchange", ranks=tr["ranks"])
    for name, kw in planted.items():
        got = train_steps(weights, batches, cfg, tr, dseed, dtype=stated, **kw)
        out[name] = against(refs, got, train_numbers)
    return out


def embed_readings(cell, seed: int, device) -> Dict[str, dict]:
    """``{"program": {"embedding_gap_max"}, "control_int8": ...}``: every
    request of the pool once through the program's embedder, and through
    its int8 path, the seed's sample of answers against the reference."""
    from titanet_torch.train.extractor import SpeakerEmbedder

    from perfbench.core import program as prog

    serving = embed_gen.Serving(cell, seed, device)
    serving.warm()
    for k in range(len(serving.pool)):
        serving.request(k)
    picks = serving.sample(cell.traffic["check"]["answers"])
    tr = cell.traffic
    quant = SpeakerEmbedder(serving.model, prog.frontend(cell.config), buckets=serving.buckets,
                            batch_size=tr["batch_size"], window_overlap=tr["window_overlap"], device=device,
                            quantized=True)
    int8 = [quant.embed(req) for req in serving.pool]
    del quant
    answers = serving.outputs
    del serving.model, serving.embedder
    _free()
    _no_tf32()
    refs = serving.references(picks)
    return {name: serving.numbers(picks, got, refs) for name, got in (("program", answers), ("control_int8", int8))}
