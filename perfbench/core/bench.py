"""The cell a run measures, the seeds it derives, the checks it makes and
the line it prints.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``. Its parts are
found by name: the configuration in ``configs``' ``file``, the traffic mix
in ``perfbench/traffic/<traffic>.json`` (whose ``generator`` names the
general generator in ``perfbench/generators/``), the limits of its
correctness check in ``perfbench/limits/<cell>.json``, and each per-layer
metric's reader in ``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX side of the repository: no run may load it (compared by whole
# top-level name: the measured package's name starts with the JAX one's)
FORBIDDEN = ("jax", "jaxlib", "flax", "titanet_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench_root: str, name: str) -> Cell:
    """The cell ``name`` of ``<bench_root>/BENCHMARK.json``, its parts read
    from ``<bench_root>/perfbench``."""
    spec = _json(os.path.join(bench_root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(bench_root, configs[w["config"]]["file"]))
    pb = os.path.join(bench_root, "perfbench")
    traffic = _json(os.path.join(pb, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(pb, "limits", f"{name}.json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def generator(cell: Cell):
    """The module of ``perfbench/generators/<generator>.py`` that the traffic names."""
    return importlib.import_module(f"perfbench.generators.{cell.traffic['generator']}")


def reader(cell: Cell, metric: str):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = os.path.join(PERFBENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each named stream of a run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in stream]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def loaded_forbidden() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name is one of
    :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


@dataclass
class Checks:
    """The numbers compared with the reference, each beside its limit."""

    items: List[tuple] = field(default_factory=list)  # (name, value, limit)

    def add(self, name: str, value: float, limit: float) -> None:
        self.items.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(math.isfinite(v) and v <= lim for _, v, lim in self.items)

    def as_dict(self) -> Dict[str, dict]:
        return {name: {"value": value, "limit": limit} for name, value, limit in self.items}

    def lines(self) -> List[str]:
        return [f"check {name}: {value!r} (limit {limit!r})" for name, value, limit in self.items]


def leaf_gap(program: Dict[str, float], reference: Dict[str, float], leaves: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    leaves = list(reference) if leaves is None else leaves
    med = float(np.median([reference[n] for n in leaves]))
    return max(abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in leaves)


def moving_leaves(grad1: Dict[str, float]) -> List[str]:
    """The leaves whose step-1 gradient in the reference is at least a
    thousandth of the median leaf's: the others (a bias under a BatchNorm,
    the attention's output bias under the softmax) are nought but for
    rounding, and Adam moves them by round-off alone."""
    med = float(np.median(list(grad1.values())))
    return [n for n, g in grad1.items() if g >= 1e-3 * med]


def train_numbers(program: dict, ref: dict) -> Dict[str, float]:
    """What a training check can compare: the worst step's relative loss
    gap and step 1's; the step-1 gradient's and the change's worst leaf
    gap (:func:`leaf_gap`) over the leaves that move
    (:func:`moving_leaves`); the median over those leaves of each one's
    relative gap, of the gradient and of the change; and the largest and
    the median distance between step 1's unit embeddings of a row (the
    program's rows ``rows`` of the global batch)."""
    keep = moving_leaves(ref["grad1"])
    loss = [abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"])]

    def median_gap(key):
        return float(np.median([abs(program[key][n] - ref[key][n]) / ref[key][n] for n in keep]))

    a, b = program.get("rows", (0, len(program["emb1"])))
    emb, ref_emb = program["emb1"], ref["emb1"][a:b]
    n = min(len(emb), len(ref_emb))
    emb_gap = np.linalg.norm(emb[:n] - ref_emb[:n], axis=-1)
    return {"loss_gap": max(loss), "loss1_gap": loss[0],
            "grad1_gap": leaf_gap(program["grad1"], ref["grad1"], keep),
            "change_gap": leaf_gap(program["delta"], ref["delta"], keep),
            "grad1_median_gap": median_gap("grad1"), "change_median_gap": median_gap("delta"),
            "emb1_gap_max": float(emb_gap.max()), "emb1_gap_median": float(np.median(emb_gap))}


def against(refs: Dict[str, dict], program, numbers) -> Dict[str, float]:
    """``numbers(program, ref)`` against each named reference, the names
    prefixed by the reference's (``f32_``, ``stated_``)."""
    return {f"{name}_{k}": v for name, ref in refs.items() for k, v in numbers(program, ref).items()}


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]) -> Checks:
    """The numbers the cell's limits name, each beside its limit."""
    checks = Checks()
    for name, limit in limits.items():
        checks.add(name, numbers[name], limit)
    return checks


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict], device: dict,
                checks: Checks, breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks.as_dict()
    return json.dumps(out)
