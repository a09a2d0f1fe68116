"""A benchmark root of toy sizes for the CPU tests: the cells' own generators,
readers, reference and limits, on a small TitaNet, a small corpus and
short requests."""

from __future__ import annotations

import json
import os
import shutil

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PERFBENCH)

TOY_MODEL = {"n_mega_blocks": 2, "hidden_size": 64, "kernel_size": 3, "output_size": 128,
             "attention_hidden_size": 128, "embedding_size": 32}

# (toy cell, toy traffic, the cell whose traffic and limits it shrinks)
CELLS = (("toy.train", "toy_train", "titanet_s.train_b128", "train_b128"),
         ("toy.dp", "toy_dp", "titanet_s.train_dp4", "train_dp4"),
         ("toy.vox", "toy_vox", "titanet_l.embed_vox", "embed_vox"),
         ("toy.diarize", "toy_diarize", "titanet_l.diarize_callhome", "diarize_callhome"))


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _dump(obj, *parts):
    path = os.path.join(*parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _shrink(name: str, traffic: dict, ranks: int) -> dict:
    t = dict(traffic)
    if t["generator"] == "train":
        t.update(rows_per_rank=8, crop_s=0.5, trace_steps=2,
                 ranks=ranks if t["ranks"] > 1 else 1,
                 corpus=dict(t["corpus"], utterances=40, speakers=8, mean_s=2.0, sd_s=0.8, min_s=0.6, max_s=4.0))
    else:
        t.update(pool=2, batch_size=8, buckets={"min_samples": 8000, "max_samples": 32000, "growth": 2.0},
                 calibration={"rows": 4, "seconds": 1.0}, check={"answers": 12}, trace_requests=1)
        if t["request"]["kind"] == "utterances":
            t["request"] = dict(t["request"], count=6, mean_s=1.5, min_s=0.6, max_s=4.0)
        else:
            t["request"] = dict(t["request"], min_s=12.0, max_s=16.0)
    return t


def make_root(tmp: str, dtype: str = "float32", ranks: int = 2) -> str:
    """``tmp`` with ``BENCHMARK.json`` and ``perfbench/{configs,traffic,
    limits}`` for the cells of :data:`CELLS`, the model in ``dtype``."""
    spec = _load(CHECKOUT, "BENCHMARK.json")
    _dump(dict(_load(PERFBENCH, "configs", "titanet_l.json"), compute_dtype=dtype, **TOY_MODEL),
          tmp, "perfbench", "configs", "toy.json")
    for cell, traffic, like, like_traffic in CELLS:
        _dump(_shrink(cell, _load(PERFBENCH, "traffic", f"{like_traffic}.json"), ranks),
              tmp, "perfbench", "traffic", f"{traffic}.json")
        os.makedirs(os.path.join(tmp, "perfbench", "limits"), exist_ok=True)
        shutil.copy(os.path.join(PERFBENCH, "limits", f"{like}.json"),
                    os.path.join(tmp, "perfbench", "limits", f"{cell}.json"))
    toy = {like: cell for cell, _, like, _ in CELLS}

    def renamed(metrics):
        return [dict(m, workloads=[toy[w] for w in m["workloads"]]) if "workloads" in m else m for m in metrics]

    _dump(dict(spec,
               configs=[{"name": "toy", "source": "toy", "file": "perfbench/configs/toy.json", "reduced": [],
                         "why": "toy"}],
               workloads=[{"name": cell, "config": "toy", "traffic": traffic, "chips": 1, "why": like}
                          for cell, traffic, like, _ in CELLS],
               end_to_end=renamed(spec["end_to_end"]), per_layer=renamed(spec["per_layer"])),
          tmp, "BENCHMARK.json")
    return tmp
