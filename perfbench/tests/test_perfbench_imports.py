"""No run loads JAX or the JAX package, the reference imports nothing of
the measured program, and a run without the program gives no result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from perfbench import run as run_module
from perfbench.core import bench
from perfbench.tests import toy

CHECKOUT = toy.CHECKOUT


@pytest.mark.parametrize("name, caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("titanet_tpu", True), ("titanet_tpu.models", True),
    ("titanet_torch", False), ("titanet_torch.train", False), ("jaxtyping", False), ("titanet_tpuish", False),
])
def test_forbidden_by_whole_top_level_name(monkeypatch, name, caught):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in bench.loaded_forbidden()) is caught


def test_run_refuses_after_jax_was_loaded(tmp_path, monkeypatch, capsys):
    root = toy.make_root(str(tmp_path))
    monkeypatch.setitem(sys.modules, "titanet_tpu.models", types.ModuleType("titanet_tpu.models"))
    rc = run_module.main(["--workload", "toy.vox", "--seed", "5", "--seconds", "0.5", "--trace", "0",
                          "--device", "cpu", "--root", root])
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == "" and "titanet_tpu.models" in err


def test_clean_run_prints_one_result(tmp_path, capsys):
    root = toy.make_root(str(tmp_path))
    rc = run_module.main(["--workload", "toy.vox", "--seed", "5", "--seconds", "0.5", "--trace", "0",
                          "--device", "cpu", "--root", root])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"embed_audio_s_per_s", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check stated_gap_")
    assert not bench.loaded_forbidden()


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.train, perfbench.reference.embed, perfbench.reference.lowp;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'titanet_torch', 'titanet_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    for name in os.listdir(os.path.join(toy.PERFBENCH, "reference")):
        if name.endswith(".py"):
            assert "titanet_torch" not in open(os.path.join(toy.PERFBENCH, "reference", name)).read()


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(toy.PERFBENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for device in ("cuda", "cpu"):
        proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "titanet_l.embed_vox", "--seed", "1",
                               "--seconds", "1", "--trace", "0", "--device", device],
                              cwd=tmp_path, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout.strip() == ""
