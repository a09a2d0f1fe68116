"""pytest set-up for ``python -m pytest perfbench/tests``.

Two fixes for shared test files that predate the first cell of a zoo model
(generator ``embed_zoo``), kept here until those files learn of such cells
(ROADMAP.md names the edits that retire both):

- ``tests/toy.py::make_root`` builds a root of toy cells, one for each
  cell of its ``CELLS``, and renames every cell a metric of
  ``BENCHMARK.json`` lists to its toy cell. A cell that ``CELLS`` does not
  mirror has no toy cell: the toy root is handed ``BENCHMARK.json`` with
  only the cells that ``CELLS`` mirrors in each list, as it held them when
  ``CELLS`` was written. The layout tests read ``BENCHMARK.json``
  themselves, whole.
- ``tests/test_perfbench_control.py`` hands every cell that does not
  train to ``control.embed_readings``, which builds TitaNet. Its case for
  a cell of another generator than ``train`` and ``embed`` skips, with a
  reason that names where that cell's program, control and faults are
  read on a card: ``test_perfbench_ecapa.py -k card``.
"""

import os

import pytest

from perfbench.tests import toy

_load = toy._load
CONTROL_GENERATORS = ("train", "embed")  # those control.py's readings build


def _mirrored_only(*parts):
    obj = _load(*parts)
    if parts[-1] == "BENCHMARK.json":
        known = {like for _, _, like, _ in toy.CELLS}
        for m in obj["end_to_end"] + obj["per_layer"]:
            if "workloads" in m:
                m["workloads"] = [w for w in m["workloads"] if w in known]
    return obj


toy._load = _mirrored_only


def pytest_collection_modifyitems(items):
    from perfbench.core import bench

    checkout = os.path.dirname(bench.PERFBENCH)
    for item in items:
        if item.originalname != "test_control_fails_and_program_passes":
            continue
        cell = bench.load_cell(checkout, item.callspec.params["workload"])
        if cell.traffic["generator"] not in CONTROL_GENERATORS:
            item.add_marker(pytest.mark.skip(
                reason=f"control.embed_readings builds TitaNet; a cell of generator "
                       f"{cell.traffic['generator']} has its program, fp8 control and planted faults read by "
                       "test_perfbench_ecapa.py -k card"))
