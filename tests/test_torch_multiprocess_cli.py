"""``python -m titanet_torch train`` data-parallel on the CPU: ranks started
by a launcher (the JAX package's environment contract, gloo) and by
``mesh.num_devices`` in one process, against one process fed the whole
global batch; the device-resident corpus sharded by rank; resume; and the
configurations that must be refused.

All runs start together once for the module (a 300 s timeout on each
process; the launched pair of ranks runs its four trainings in turn): a
toy TitaNet (one mega-block), dropout 0.5, SpecAugment and device-side
noise, SGD, two epochs:

- ``ref``: one process, ``batch_size: 8``;
- ``launch``: two ranks under ``TITANET_COORDINATOR``/..., ``batch_size: 4``
  each: rank r reads batches r, r+2, ... of the epoch, so the global batch
  of each step is ``ref``'s batch, ragged rows padded to the width the ranks
  agree on;
- ``spawned``: ``mesh.num_devices: 2``, ``batch_size: 8``, with
  ``generic.device_corpus`` (its int16 windows equal the host loader's):
  two local ranks keep rows 0-3 and 4-7 of each batch's descriptor;
- ``dc``: two launched ranks with ``generic.device_corpus`` (one epoch);
- ``resume``: ``launch`` stopped after epoch 1, then resumed to 2.

The per-epoch metrics of ``launch`` and ``spawned`` equal ``ref``'s to
1e-5, their final parameters within 5e-5 of each tensor's largest entry
(+1e-6, as tests/test_torch_parallel.py), the ranks' parameter checksums
agree, rank 0 alone writes, and ``resume`` ends with ``launch``'s bits.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parallel_helpers import REPO, communicate, free_port, rank_env
from titanet_torch import cli
from titanet_torch.config import Config
from titanet_torch.train import checkpoint as ckpt

# one rank: train each config through the CLI's main in turn, printing the
# parameter checksum of each run
RANK = ("import json, sys; from titanet_torch import cli\n"
        "for p in sys.argv[1:]:\n"
        "    s = cli.main(['train', '-p', p, '--device', 'cpu'])\n"
        "    print('RESULT', json.dumps(None if s is None else "
        "sum(float(p.detach().double().abs().sum()) for p in s.params())))")
PARAM_TOL = 5e-5


def _config(tmp, name, batch_size, epochs=2, **sections):
    cfg = {"dataset": {"name": "synthetic", "synthetic_speakers": 4, "synthetic_utterances": 6},
           "training": {"batch_size": batch_size, "epochs": epochs, "checkpoints_path": str(tmp / "ck"),
                        "checkpoints_frequency": 1, "run_name": name,
                        "optimizer": {"type": "sgd", "start_lr": 3e-4}},
           "validation": {"every": 1, "batch_size": 4, "num_utterances_per_speaker": 1},
           "test": {"num_speakers": 2, "num_utterances_per_speaker": 2},
           "titanet": {"n_mega_blocks": 1, "dropout": 0.5},
           "augmentation": {"probability": 1.0, "enable": ["specaugment", "noise"]},
           "generic": {"workers": 0}}
    for key, value in sections.items():
        cfg[key] = {**cfg.get(key, {}), **value}
    path = tmp / f"{name}-{epochs}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _start(paths, ranks=0):
    """One process (``ranks`` 0) or ``ranks`` processes under the launcher
    contract, training each of ``paths`` in turn on the CPU."""
    cmd = [sys.executable, "-c", RANK, *paths]
    if not ranks:
        return [subprocess.Popen(cmd, cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)]
    port = free_port()
    return [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=rank_env(TITANET_COORDINATOR=f"127.0.0.1:{port}", TITANET_NUM_PROCESSES=ranks,
                                          TITANET_PROCESS_ID=r))
            for r in range(ranks)]


def _finish(procs):
    """Each process's checksums, one a run."""
    results = []
    for rc, log in communicate(procs, timeout=300):
        assert rc == 0, log[-4000:]
        results.append([json.loads(line[7:]) for line in log.splitlines() if line.startswith("RESULT ")])
    return results


LAUNCHED = ("launch", "dc", "resume-1", "resume")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_cli")
    started = {
        "ref": _start([_config(tmp, "ref", 8)]),
        "spawned": _start([_config(tmp, "spawned", 8, mesh={"num_devices": 2}, generic={"device_corpus": True})]),
        "launched": _start([_config(tmp, "launch", 4), _config(tmp, "dc", 4, epochs=1, generic={"device_corpus": True}),
                            _config(tmp, "resume", 4, epochs=1),
                            _config(tmp, "resume", 4, training={"resume": True})], ranks=2),
    }
    out = {name: _finish(procs) for name, procs in started.items()}
    # {run: [rank 0's checksum, rank 1's]} of the launched runs
    out.update({run: [out["launched"][r][i] for r in range(2)] for i, run in enumerate(LAUNCHED)})
    out["spawned"] = out["spawned"][0]
    return tmp / "ck", out


def _records(run_dir):
    """{(epoch, split): record without times} of a run's metrics.jsonl;
    asserts that no record is written twice."""
    out = {}
    for line in open(os.path.join(run_dir, "metrics.jsonl")):
        rec = json.loads(line)
        split = next(k.split("/")[0] for k in rec if "/" in k)
        key = (rec["epoch"], split)
        assert key not in out, f"{key} written twice"
        out[key] = {k: v for k, v in rec.items() if "/" in k and "time" not in k}
    return out


def _assert_same_run(ck, name):
    got, ref = _records(ck / name), _records(ck / "ref")
    assert set(got) == set(ref) == {(e, s) for e in (1, 2) for s in ("train", "val")} | {(2, "test")}
    for key, want in ref.items():
        assert set(got[key]) == set(want), key
        for metric, value in want.items():
            np.testing.assert_allclose(got[key][metric], value, rtol=1e-5, atol=1e-7, err_msg=f"{key} {metric}")
    a, b = ckpt.read_checkpoint(str(ck / name), 2), ckpt.read_checkpoint(str(ck / "ref"), 2)
    for part in ("model", "head"):
        for key, want in b[part].items():
            assert (a[part][key] - want).abs().max().item() <= PARAM_TOL * want.abs().max().item() + 1e-6, key


def test_launcher_contract_two_ranks_equal_one_process_fed_the_global_batch(runs):
    ck, out = runs
    _assert_same_run(ck, "launch")
    c0, c1 = out["launch"]
    np.testing.assert_allclose(c0, c1, rtol=1e-6)
    assert sorted(os.listdir(ck / "launch")) == ["0", "1", "2", "metrics.jsonl"]


def test_mesh_num_devices_starts_local_ranks_that_split_each_batch(runs):
    ck, out = runs
    _assert_same_run(ck, "spawned")
    assert len(out["spawned"]) == 1 and out["spawned"][0] is not None  # rank 0's state, returned here


def test_device_corpus_with_a_static_shard_a_rank(runs):
    ck, out = runs
    c0, c1 = out["dc"]
    np.testing.assert_allclose(c0, c1, rtol=1e-6)
    recs = _records(ck / "dc")
    assert np.isfinite(recs[(1, "train")]["train/avg_loss"]) and ckpt.latest_epoch(str(ck / "dc")) == 1
    # what each rank attaches: its train loader's share of the corpus only,
    # validation host-fed; and its gathered rows
    cfg = Config.from_dict(json.loads(open(_config(ck.parent, "dc", 4, epochs=1,
                                                   generic={"device_corpus": True})).read()))
    train_ds, val_ds, test_ds, _ = cli._datasets(cfg, True)
    owned = []
    for rank in range(2):
        train, val, _ = cli._loaders(cfg, train_ds, val_ds, test_ds, None, shard=(rank, 2))
        cli._attach_device_corpus(cfg, [train, val], torch.device("cpu"))
        corpus = train._device_corpus
        assert val._device_corpus is None
        assert corpus.n_owned == len(train.device_shard_root_indices()) < len(corpus.offsets)
        owned.append(set(np.flatnonzero(corpus.offsets >= 0).tolist()))
        train.set_epoch(1)
        batch = next(iter(train))
        wav, lengths, speakers = batch.gather_global(cli.make_mesh(device="cpu"))
        assert wav.shape == (4, batch.t) and torch.equal(lengths, torch.from_numpy(batch.lengths))
    assert not owned[0] & owned[1]


def test_resume_equals_the_straight_run(runs):
    ck, _ = runs
    a, b = ckpt.read_checkpoint(str(ck / "resume"), 2), ckpt.read_checkpoint(str(ck / "launch"), 2)
    for part in ("model", "head"):
        for key in b[part]:
            assert torch.equal(a[part][key], b[part][key]), key
    assert _records(ck / "resume")[(2, "train")] == _records(ck / "launch")[(2, "train")]


def test_num_devices_none_takes_every_visible_card(monkeypatch, tmp_path):
    """As the JAX mesh takes every visible device: one rank a card on
    ``cuda``; one process on the CPU, on a named card, or under a
    launcher."""
    cfg = Config.from_dict(json.loads(open(_config(tmp_path, "x", 8)).read()))
    assert cfg.mesh.num_devices is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli._ranks_to_start(cfg, torch.device("cuda"), 1) == 2
    assert cli._ranks_to_start(cfg, torch.device("cuda", 1), 1) == 0
    assert cli._ranks_to_start(cfg, torch.device("cpu"), 1) == 0
    assert cli._ranks_to_start(cfg, torch.device("cuda"), 2) == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="batch_size 8 does not split over mesh.num_devices 3"):
        cli._ranks_to_start(cfg, torch.device("cuda"), 1)


def test_meshes_the_cli_refuses(monkeypatch, tmp_path):
    cfg = lambda **mesh: Config.from_dict(json.loads(open(_config(tmp_path, "x", 8, mesh=mesh)).read()))  # noqa: E731
    cpu = torch.device("cpu")
    assert cli._ranks_to_start(cfg(num_devices=None), cpu, 1) == 0
    assert cli._ranks_to_start(cfg(num_devices=2), cpu, 1) == 2
    assert cli._ranks_to_start(cfg(num_devices=2), cpu, 2) == 0
    with pytest.raises(ValueError, match="batch_size 8 does not split over mesh.num_devices 3"):
        cli.train(cfg(num_devices=3), device="cpu")
    with pytest.raises(ValueError, match="mesh.num_devices is 3 but the launcher started 2 ranks"):
        cli._ranks_to_start(cfg(num_devices=3), cpu, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh.num_devices is 2 but 1 CUDA devices are visible"):
        cli._ranks_to_start(cfg(num_devices=2), torch.device("cuda"), 1)
