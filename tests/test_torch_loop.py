"""The port's engine (titanet_torch/train/loop.py, checkpoint.py, cli.py,
utils/logging.py) on the CPU: one f32 epoch against the JAX loop from the
same weights, resume against a straight run, the CLI end to end, the
non-finite abort, best checkpoint and early stopping, the event file, and
the config keys that are not ported yet."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch import cli
from titanet_torch import data as td
from titanet_torch.config import Config
from titanet_torch.losses import heads as th
from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.ops.augment import AugmentConfig
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.ops.kernels import melspec
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train import loop as tl
from titanet_torch.train import state as ts
from titanet_torch.utils import TensorBoardLogger
from titanet_torch.utils.weights import load_jax_train_state
from titanet_tpu import data as jd
from titanet_tpu.losses import heads as jh
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.train import loop as jl
from titanet_tpu.train import state as js
from titanet_tpu.utils import tb_events as jtb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256)
CORPUS = dict(n_speakers=4, utterances_per_speaker=4, min_seconds=1.0, max_seconds=1.3, seed=0)


def _loader(pkg, **kw):
    return pkg.DataLoader(pkg.SyntheticSpeakerDataset(**CORPUS), batch_size=4, seed=3, prefetch=0,
                          chunk=pkg.ChunkConfig(enabled=False), **kw)


def _torch_state(dropout=0.0, ema=False, name="sgd", lr=3e-4, seed=0):
    model = TorchTitaNet(dropout=dropout, **SMALL)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    head = th.build_head("ce", 192, 4, device="cpu")
    return ts.create_train_state(model, head, ts.make_optimizer(name=name, start_lr=lr), seed=seed, ema=ema)


def test_one_f32_epoch_matches_the_jax_loop():
    """From weights carried across with load_jax_train_state, f32, dropout
    0, no augmentation: every metric of one epoch of train_one_epoch on the
    same batches equals the JAX loop's, the losses within 1e-4 (the step
    tolerance of test_torch_train), accuracy and the class-count metrics
    exactly; the host times are not compared. SGD at 3e-4 keeps gradient
    rounding rounding (Adam's first step moves every parameter by +-lr
    whatever its gradient's size: see test_torch_train's tolerances). The
    updates still count: the same epoch at lr 0 ends more than 100 x the
    tolerance away, so a missing or wrong update cannot pass."""
    jm, jhd = JaxTitaNet(dropout=0.0, **SMALL), jh.build_head("ce", 192, 4)
    jopt = js.make_optimizer(name="sgd", start_lr=3e-4)
    jst = js.create_train_state(jax.random.key(0), jm, jhd, jopt, jnp.zeros((2, 101, 80)), 4)
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    weights = tree(jst.params), tree(jst.batch_stats)  # before the epoch donates jst
    _, jmet, _ = jl.train_one_epoch(1, 1, jst, _loader(jd), model=jm, head=jhd, optimizer=jopt,
                                    frontend=JaxFrontend.from_ms())
    tmet = {}
    for lr in (3e-4, 0.0):
        tst = _torch_state(lr=lr)
        load_jax_train_state(tst.model, tst.head, *weights)
        tst, tmet[lr], _ = tl.train_one_epoch(1, 1, tst, _loader(td), frontend=TorchFrontend.from_ms())
        assert tst.step == 4
    assert set(tmet[3e-4]) == set(jmet)
    for k in sorted(jmet):
        if "time" in k:
            continue
        if "loss" in k:
            np.testing.assert_allclose(tmet[3e-4][k], jmet[k], rtol=1e-4, err_msg=k)
        else:
            assert tmet[3e-4][k] == jmet[k], k
    frozen = abs(tmet[0.0]["train/avg_loss"] / jmet["train/avg_loss"] - 1)
    assert frozen > 100 * 1e-4, frozen


def _run(path, epochs, resume, state, **kw):
    return tl.training_loop(
        "run", epochs, state, _loader(td), str(path), frontend=TorchFrontend.from_ms(),
        augment=AugmentConfig(noise_prob=0.5, probability=0.7), ema_decay=0.9,
        val_loader=_loader(td, shuffle=False), val_every=1, checkpoints_frequency=1, resume=resume,
        jsonl=tl.JsonlLogger(os.path.join(str(path), "metrics.jsonl")), **kw,
    )


def test_resume_equals_a_straight_run_bit_for_bit(tmp_path):
    """Adam, dropout 0.5, SpecAugment and noise, weight EMA: a run stopped
    after epoch 1 and resumed from its checkpoint ends with the straight
    run's parameters, buffers, optimizer state, EMA, generators and epoch-2
    metrics, bit for bit."""
    kw = dict(dropout=0.5, ema=True, name="adam", lr=1e-3)
    straight = _run(tmp_path / "a", 2, False, _torch_state(**kw))
    _run(tmp_path / "b", 1, False, _torch_state(**kw))
    assert ckpt.latest_epoch(str(tmp_path / "b" / "run")) == 1
    resumed = _run(tmp_path / "b", 2, True, _torch_state(**kw, seed=9))  # other weights: all restored
    for a, b in ((straight.model, resumed.model), (straight.head, resumed.head)):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), name
    for name in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(getattr(straight.opt_state, name),
                                                      getattr(resumed.opt_state, name)))
    assert all(torch.equal(x, y) for x, y in zip(straight.ema, resumed.ema))
    assert straight.step == resumed.step == 8 and straight.opt_state.count == resumed.opt_state.count
    for k, g in straight.generators().items():
        assert torch.equal(g.get_state(), resumed.generators()[k].get_state()), k

    def epoch2(path):
        recs = [json.loads(line) for line in open(path / "metrics.jsonl")]
        return {k: v for r in recs if r["epoch"] == 2 for k, v in r.items() if "time" not in k and k != "ts"}

    assert epoch2(tmp_path / "a") == epoch2(tmp_path / "b")


def test_checkpoint_restore_rejects_a_mismatched_state(tmp_path):
    st = _torch_state(ema=True)
    for epoch in (0, 7, 3):
        ckpt.save_checkpoint(str(tmp_path), epoch, st)
    assert sorted(os.listdir(tmp_path)) == ["0", "3", "7"] and ckpt.latest_epoch(str(tmp_path)) == 7
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path), 7, _torch_state(ema=False))
    assert ckpt.restore_latest(str(tmp_path / "none"), st) == (None, 0)


def test_best_checkpoint_and_early_stopping(tmp_path, monkeypatch):
    """Validation losses 3.0, 2.0, 2.5, 2.6, ...: the best checkpoint (0)
    holds epoch 2's state and patience 2 stops the run after epoch 4."""
    values = iter([3.0, 2.0, 2.5, 2.6, 2.7, 2.8])
    monkeypatch.setattr(tl, "evaluate", lambda *a, **k: ({"val/avg_loss": next(values)}, None))
    loader = _loader(td)
    tl.training_loop("run", 6, _torch_state(), loader, str(tmp_path), frontend=TorchFrontend.from_ms(),
                     val_loader=loader, val_every=1, checkpoints_frequency=None, early_stop_patience=2)
    run = str(tmp_path / "run")
    assert ckpt.latest_epoch(run) == 4
    best = torch.load(os.path.join(run, "0", ckpt.FILENAME), weights_only=True)
    assert best["step"] == 2 * len(loader)


def test_non_finite_loss_aborts():
    st = _torch_state()
    with torch.no_grad():
        st.head.fc.weight.fill_(float("nan"))
    with pytest.raises(tl.NonFiniteLossError, match="step 1"):
        tl.train_one_epoch(1, 1, st, _loader(td), frontend=TorchFrontend.from_ms(), nan_check_every=1)
    with pytest.raises(tl.NonFiniteLossError, match="during epoch 1"):
        tl.train_one_epoch(1, 1, st, _loader(td), frontend=TorchFrontend.from_ms(), nan_check_every=0)
    with pytest.raises(tl.NonFiniteLossError, match="Loss is nan"):
        tl.train_one_epoch(1, 1, st, _loader(td), frontend=TorchFrontend.from_ms(),
                           console=tl.ConsoleLogger(enabled=True))


def test_event_file_reads_back_through_the_jax_reader(tmp_path):
    tb = TensorBoardLogger(str(tmp_path / "tb"))
    tl.training_loop("run", 1, _torch_state(), _loader(td), str(tmp_path / "ck"),
                     frontend=TorchFrontend.from_ms(), test_loader=_loader(td, shuffle=False, drop_last=False),
                     checkpoints_frequency=None, tb=tb)
    tb.finish()
    (path,) = [os.path.join(tmp_path / "tb", f) for f in os.listdir(tmp_path / "tb")]
    scalars = {}
    for ev in jtb.read_events(path):
        scalars.update(ev["scalars"])
    assert {"train/avg_loss", "train/accuracy", "test/eer", "test/mindcf"} <= set(scalars)
    assert np.isfinite(scalars["train/avg_loss"]) and 0.0 <= scalars["test/eer"] <= 1.0


def test_verification_cohort_and_calibration_and_chunk_refusal():
    st = _torch_state()
    kw = dict(frontend=TorchFrontend.from_ms())
    m = tl.run_verification(st, _loader(td, shuffle=False, drop_last=False),
                            cohort_loader=_loader(td, shuffle=False), cohort_topk=5, calibrate=True, **kw)
    assert {"test/eer", "test/mindcf", "test/cllr", "test/min_cllr", "test/act_dcf"} <= set(m)
    chunking = td.DataLoader(td.SyntheticSpeakerDataset(**CORPUS), batch_size=4, prefetch=0,
                             chunk=td.ChunkConfig())
    with pytest.raises(ValueError, match="non-chunking"):
        tl.run_verification(st, chunking, **kw)
    emb, spk = tl.infer(st, td.SyntheticSpeakerDataset(**CORPUS), [0, 5, 9], batch_size=2, **kw)
    assert emb.shape == (3, 192) and spk == [0, 1, 2]


def _yaml(tmp_path, name, extra=""):
    path = tmp_path / f"{name}.yml"
    path.write_text(f"""
dataset: {{name: synthetic, synthetic_speakers: 4, synthetic_utterances: 6}}
training: {{batch_size: 4, epochs: 2, checkpoints_path: "{tmp_path / 'ck'}", checkpoints_frequency: 1,
           run_name: {name}, ema_decay: 0.5}}
validation: {{every: 1, batch_size: 4, num_utterances_per_speaker: 1}}
test: {{num_speakers: 2, num_utterances_per_speaker: 2, score_norm: snorm, cohort_size: 8,
       calibration: true}}
titanet: {{n_mega_blocks: 1, dropout: 0.1}}
augmentation: {{probability: 1.0, enable: [chunk, specaugment, noise, speed]}}
generic: {{workers: 1, tensorboard_dir: "{tmp_path / 'tb'}"}}
{extra}""")
    return str(path)


def test_cli_train_and_eval_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """``python -m titanet_torch train -p <yml> --device cpu``, then a
    distilled student from that run as teacher, then ``eval``. The student's
    frontend goes through the fused log-mel wrapper (its plain version on
    the CPU), the route the card runs, though the YAML leaves
    ``audio.use_pallas_fused`` false."""
    proc = subprocess.run([sys.executable, "-m", "titanet_torch", "train", "-p", _yaml(tmp_path, "teacher"),
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = str(tmp_path / "ck" / "teacher")
    assert ckpt.latest_epoch(run) == 2 and os.path.isdir(os.path.join(run, "0"))
    recs = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    test = [r for r in recs if "test/eer" in r][0]
    assert {"test/cllr", "test/act_dcf"} <= set(test)
    student = _yaml(tmp_path, "student", f"distill: {{enabled: true, teacher_checkpoint: \"{run}\", alpha: 0.5}}")
    calls = []
    fused = melspec.log_mel_fused
    monkeypatch.setattr(melspec, "log_mel_fused", lambda *a, **k: calls.append(1) or fused(*a, **k))
    assert not cli.load_config(student).audio.use_pallas_fused
    cli.main(["train", "-p", student, "--device", "cpu"])
    assert calls
    assert ckpt.latest_epoch(str(tmp_path / "ck" / "student")) == 2
    metrics = cli.evaluate_checkpoint(cli.load_config(student), str(tmp_path / "ck" / "student"), device="cpu")
    assert 0.0 <= metrics["test/eer"] <= 1.0 and 0.0 <= metrics["test/mindcf"] <= 1.0
    cli.main(["eval", "-p", student, "-c", str(tmp_path / "ck" / "student"), "-e", "1", "--device", "cpu"])


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train(Config.from_dict({"dataset": {"name": "synthetic"}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(td.device_prefetch(iter([]), device="cuda"))
