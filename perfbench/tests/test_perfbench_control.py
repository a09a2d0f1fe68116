"""On the card, at each cell's own sizes: the program reads under its
cell's limits and the control over them, on several seeds; for a training
cell the half-batch fault too (and, across ranks, the exchange left out),
planted in the reference. ``PERFBENCH_CONTROL_SEEDS`` sets how many seeds
(3 by default); each seed's readings are printed as one JSON line.

    python -m pytest perfbench/tests/test_perfbench_control.py -s -k <cell>
"""

import json
import os

import pytest
import torch

from perfbench.core import bench
from perfbench.tests import control

CHECKOUT = os.path.dirname(bench.PERFBENCH)
SPEC = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
SEED0 = 3_000_000_000


def _seeds():
    return [SEED0 + 7919 * i for i in range(int(os.environ.get("PERFBENCH_CONTROL_SEEDS", "3")))]


def _over(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = bench.load_cell(CHECKOUT, workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from titanet_torch.utils import enable_compilation_cache

    enable_compilation_cache(os.path.join(bench.PERFBENCH, ".cache", "kernels"))
    seen = []
    for seed in _seeds():
        if cell.traffic["generator"] == "train":
            readings = control.train_readings(cell, seed, device, program=cell.traffic["ranks"] == 1)
        else:
            readings = control.embed_readings(cell, seed, device)
        print(json.dumps({"cell": workload, "seed": seed, **readings}), flush=True)
        seen.append(readings)
    for readings in seen:
        if "program" in readings:
            assert not _over(readings["program"], cell.limits)
        for name, numbers in readings.items():
            if name not in ("program", "look"):
                assert _over(numbers, cell.limits), name
