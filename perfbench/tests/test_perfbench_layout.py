"""BENCHMARK.json against the contract's shape, and every part of every
cell found by name."""

import importlib
import json
import os
import re

import pytest

from perfbench.core import bench

CHECKOUT = os.path.dirname(bench.PERFBENCH)
SPEC = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
END_TO_END = {m["name"] for m in SPEC["end_to_end"]}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"} and NAME.match(entry["name"])
    cfg = json.load(open(os.path.join(CHECKOUT, entry["file"])))
    assert entry["file"].startswith("perfbench/") and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"] and cfg["assumed"]


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cell = bench.load_cell(CHECKOUT, w["name"])
    assert bench.generator(cell).run
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(bench.reader(cell, m["name"]))
        assert m["moves"] in names


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in END_TO_END and "\n" not in m["layer"]
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_readers_need_no_edit_to_add_a_metric():
    """Every per-layer metric is a file of its own; the core names none."""
    core = "".join(open(os.path.join(bench.PERFBENCH, d, f)).read()
                   for d in ("core", ".") for f in os.listdir(os.path.join(bench.PERFBENCH, d)) if f.endswith(".py"))
    for m in SPEC["per_layer"]:
        assert m["name"] not in core
    for w in SPEC["workloads"]:
        assert w["name"] not in core and w["traffic"] not in core and w["config"] not in core
    assert importlib.import_module("perfbench.metrics._counts")
