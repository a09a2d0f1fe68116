"""A whole run on the CPU at toy sizes (no look for a card), with the
timed path broken underneath: ``correct`` must come out false for each
fault a cell can have, and true without one."""

import json
import os
import sys

import pytest
import torch

from perfbench import run as run_module
from perfbench.tests import toy

FAULTS_SITE = """
import os
fault = os.environ.get("PERFBENCH_TEST_FAULT")
if fault == "no_exchange":
    import titanet_torch.train.state as state
    state.mean_over_ranks = lambda tensors, mesh, kind="gradients": list(tensors)
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(str(tmp_path_factory.mktemp("bench")))


def run_cell(root, workload, capsys, seconds=1.0):
    rc = run_module.main(["--workload", workload, "--seed", str(2**31 + 11), "--seconds", str(seconds),
                          "--trace", "0", "--device", "cpu", "--root", root])
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def unchanged_step(orig):
    def step(state, *args, **kwargs):
        saved = [p.detach().clone() for p in state.params()]
        out = orig(state, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(state.params(), saved):
                p.copy_(s)
        return out
    return step


def half_batch_step(orig):
    def step(state, wav, lengths, spk, **kwargs):
        half = wav.shape[0] // 2
        state, m = orig(state, wav[:half], None if lengths is None else lengths[:half], spk[:half], **kwargs)
        m = dict(m, preds=torch.cat([m["preds"], m["preds"]]))
        return state, m
    return step


def stale_embed(orig):
    last = {}

    def step(model, waveform, lengths, **kwargs):
        out = orig(model, waveform, lengths, **kwargs)
        key = tuple(waveform.shape)
        prev, last[key] = last.get(key), out
        return out if prev is None else prev
    return step


def half_embed(orig):
    def step(model, waveform, lengths, **kwargs):
        half = waveform.shape[0] // 2
        out = orig(model, waveform[:half], lengths[:half], **kwargs)
        return torch.cat([out, out])[: waveform.shape[0]]
    return step


def altered_embed(orig):
    def step(model, waveform, lengths, **kwargs):
        return torch.roll(orig(model, waveform, lengths, **kwargs), 1, dims=0)
    return step


@pytest.mark.parametrize("workload", ["toy.train", "toy.vox", "toy.diarize"])
def test_sound_run_is_correct(root, workload, capsys):
    assert run_cell(root, workload, capsys)["correct"]


@pytest.mark.parametrize("fault", [unchanged_step, half_batch_step], ids=["unchanged", "half_batch"])
def test_training_faults_are_caught(root, fault, monkeypatch, capsys):
    import titanet_torch.train.state as state

    monkeypatch.setattr(state, "train_step", fault(state.train_step))
    assert not run_cell(root, "toy.train", capsys)["correct"]


@pytest.mark.parametrize("fault", [stale_embed, half_embed, altered_embed], ids=["stale", "half_batch", "altered"])
@pytest.mark.parametrize("workload", ["toy.vox", "toy.diarize"])
def test_serving_faults_are_caught(root, workload, fault, monkeypatch, capsys):
    import titanet_torch.train.extractor as extractor

    monkeypatch.setattr(extractor, "embed_step", fault(extractor.embed_step))
    assert not run_cell(root, workload, capsys)["correct"]


def test_exchange_left_out_is_caught(root, tmp_path, monkeypatch, capsys):
    """Two gloo ranks on the CPU; every rank skips the gradient's
    all-reduce."""
    import titanet_torch.train.state as state

    (tmp_path / "sitecustomize.py").write_text(FAULTS_SITE)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path), toy.CHECKOUT]))
    monkeypatch.setenv("PERFBENCH_TEST_FAULT", "no_exchange")
    monkeypatch.setattr(state, "mean_over_ranks", lambda tensors, mesh, kind="gradients": list(tensors))
    assert not run_cell(root, "toy.dp", capsys, seconds=2.0)["correct"]


def test_two_ranks_sound(root, capsys):
    line = run_cell(root, "toy.dp", capsys, seconds=2.0)
    assert line["correct"] and line["device"]["count"] == 2
    assert sys.modules.get("jax") is None
