"""The model zoo through the port's command line on the CPU:
``build_model`` builds each config family as the JAX package's
``build_model`` does (class, parameter count, precedence), and an x-vector
student distils from a TitaNet teacher through ``python -m titanet_torch
train`` (``distill.teacher_overrides`` naming the teacher's family), then
``eval`` and ``infer`` on its run."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch import cli
from titanet_torch.config import Config
from titanet_torch.models import count_params
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train import state as ts
from titanet_tpu import cli as jcli
from titanet_tpu.config import Config as JaxConfig

FAMILIES = ("dumb", "baseline", "ecapa", "xvector", "resnet", "conformer")


def _jax_count(model) -> int:
    v = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 200, 80))))
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(v["params"]))


@pytest.mark.parametrize("family", FAMILIES + ("titanet",))
def test_build_model_builds_every_config_family_as_jax(family):
    """The config's defaults (the published widths), in f32 and bf16: the
    JAX package's class, the same parameter count, eval mode on the CPU,
    the dtype passed down; a forward gives ``[B, embedding_size]``."""
    d = {} if family == "titanet" else {family: {"enabled": True}}
    cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
    jmodel = jcli.build_model(jcfg)
    for dtype in (None, torch.bfloat16):
        model = cli.build_model(cfg, dtype=dtype, device="cpu", generator=torch.Generator().manual_seed(1))
        assert type(model).__name__ == type(jmodel).__name__ and not model.training
        assert model.dtype == dtype and model.embedding_size == cfg.generic.embedding_size
    assert count_params(model) == _jax_count(jmodel)
    with torch.no_grad():
        out = model(torch.randn(2, 101, 80))
    assert out.shape == (2, cfg.generic.embedding_size) and torch.isfinite(out.float()).all()


def test_build_model_follows_the_jax_precedence():
    """dumb, then baseline, ecapa, xvector, resnet, conformer, then TitaNet:
    with every family enabled the first wins; turning it off hands over to
    the next, as in the JAX package."""
    enabled = {f: {"enabled": True} for f in FAMILIES}
    for i in range(len(FAMILIES) + 1):
        d = {**enabled, **{f: {"enabled": False} for f in FAMILIES[:i]}}
        model = cli.build_model(Config.from_dict(d), device="cpu")
        assert type(model).__name__ == type(jcli.build_model(JaxConfig.from_dict(d))).__name__


def _json(tmp_path, name, extra):
    """A ``-p`` config as JSON (the same schema as YAML)."""
    import json

    d = {
        "dataset": {"name": "synthetic", "synthetic_speakers": 4, "synthetic_utterances": 6},
        "training": {"batch_size": 4, "epochs": 2, "checkpoints_path": str(tmp_path / "ck"),
                     "checkpoints_frequency": 1, "run_name": name},
        "validation": {"every": 1, "batch_size": 4, "num_utterances_per_speaker": 1},
        "test": {"num_speakers": 2, "num_utterances_per_speaker": 2},
        "titanet": {"n_mega_blocks": 1},
        "xvector": {"hidden_size": 32, "frame_out": 64},
        "augmentation": {"enable": ["chunk"]},
        "generic": {"workers": 1},
        **extra,
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(d))
    return str(path)


def test_xvector_student_distils_from_a_titanet_teacher_through_the_cli(tmp_path, monkeypatch):
    """A TitaNet teacher's checkpoint (its architecture: the student's
    config with ``xvector.enabled`` overridden off), a 2-epoch x-vector
    student through ``cli.main(["train", ...])`` whose every step embeds
    with the teacher, then ``eval`` and ``infer`` on the student's run."""
    teacher_dir = str(tmp_path / "teacher")
    teacher_cfg = Config.from_dict({"titanet": {"n_mega_blocks": 1}, "training": {"run_name": "teacher"}})
    _, _, _, t_state = cli._rebuild_state(teacher_cfg, n_speakers=4, device="cpu")
    ckpt.save_checkpoint(teacher_dir, 1, t_state)
    params = _json(tmp_path, "student", {"xvector": {"enabled": True, "hidden_size": 32, "frame_out": 64},
                                         "distill": {"enabled": True, "teacher_checkpoint": teacher_dir,
                                                     "teacher_overrides": {"xvector.enabled": False},
                                                     "alpha": 0.5}})
    teachers = []
    real = ts.loss_and_grads

    def spy(state, *a, teacher_model=None, **k):
        teachers.append((type(state.model).__name__, type(teacher_model).__name__))
        return real(state, *a, teacher_model=teacher_model, **k)

    monkeypatch.setattr(ts, "loss_and_grads", spy)
    state = cli.main(["train", "-p", params, "--device", "cpu"])
    run = str(tmp_path / "ck" / "student")
    assert type(state.model).__name__ == "XVector" and ckpt.latest_epoch(run) == 2
    assert teachers and set(teachers) == {("XVector", "TitaNet")}
    # the teacher holds the checkpoint's weights
    t_model, alpha = cli._load_teacher(cli.load_config(params), 4, device="cpu")
    assert alpha == 0.5
    for (k, v), (_, w) in zip(t_model.state_dict().items(), t_state.model.state_dict().items()):
        assert torch.equal(v, w), k
    metrics = cli.main(["eval", "-p", params, "-c", run, "--device", "cpu"])
    assert 0.0 <= metrics["test/eer"] <= 1.0 and 0.0 <= metrics["test/mindcf"] <= 1.0
    emb, _ = cli.main(["infer", "-p", params, "-c", run, "--split", "test", "-n", "4", "--device", "cpu"])
    assert emb.shape == (4, 192) and np.allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
    restored, _, _ = cli._restore_for_eval(cli.load_config(params), 4, run, None, "cpu")
    assert type(restored.model).__name__ == "XVector"
    assert os.path.isfile(os.path.join(run, "metrics.jsonl"))
