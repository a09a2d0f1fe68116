"""Shared checks of the model zoo's port against the JAX package on the CPU
(tests/test_torch_{ecapa,xvector,resnet,conformer,baselines}.py): one
small model of a family in both packages with the same weights (JAX init,
BatchNorm running statistics drawn from a seeded numpy generator so every
BatchNorm does real work), carried across by ``load_jax_variables``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from titanet_torch.losses import heads as th
from titanet_torch.models import count_params
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.train import state as ts
from titanet_torch.utils.weights import load_jax_train_state, load_jax_variables
from titanet_tpu.losses import heads as jh
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.train import state as js

N_CLASSES = 6
# f32 forward and train-step tolerances (as tests/test_torch_train.py's):
# outputs within 1e-4 of their largest entry; one SGD step's loss within
# 1e-4 relative, every parameter and running statistic within 5e-5 of its
# tensor's largest entry (+1e-6)
FWD_TOL, LOSS_RTOL, PARAM_TOL = 1e-4, 1e-4, 5e-5


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_batch_stats(tree, rng):
    """Every BatchNorm's ``mean``/``var`` redrawn: means ~0.1 N(0, 1),
    variances U(0.5, 2)."""
    if "mean" in tree and "var" in tree and not isinstance(tree["mean"], dict):
        n = tree["mean"].shape
        return {"mean": (rng.standard_normal(n) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    return {k: random_batch_stats(v, rng) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def jax_variables(jmodel, seed=0, t=101):
    """The JAX model's variables as numpy trees, BatchNorm statistics random
    (kept for the file's other tests: callers copy, never write)."""
    v = tree_np(dict(jmodel.init(jax.random.key(seed), jnp.zeros((2, t, 80), jnp.float32))))
    v.setdefault("batch_stats", {})
    v["batch_stats"] = random_batch_stats(v["batch_stats"], np.random.default_rng(seed))
    return v


def load(tmodel, variables):
    return load_jax_variables(tmodel, variables["params"], variables["batch_stats"]).eval()


def mel_batch(seed=1, b=3, t=83, lengths=(83, 60, 37)):
    """Seeded mel-like input and its frame mask (rows zero past their length)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, 80)) * 0.5).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return x * mask[..., None], mask


def check_forward(jmodel, tmodel, masked, seed=0):
    """Eval forward: max |port - JAX| <= 1e-4 x the largest entry."""
    v = jax_variables(jmodel, seed)
    load(tmodel, v)
    x, mask = mel_batch(seed + 1)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(x), mask=jnp.asarray(mask) if masked else None))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), mask=torch.from_numpy(mask) if masked else None).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= FWD_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def wave(seed=0, b=4, n=16000):
    """Rows that differ in spectrum and level (a tone of its own over noise)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tones = np.stack([np.sin(2 * np.pi * (150.0 * 2 ** i) * t) * 0.3 / (i + 1) for i in range(b)])
    return (tones + rng.standard_normal((b, n)) * 0.05).astype(np.float32)


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


EMBED_LENGTHS = (16000, 11000, 7000)


@functools.lru_cache(maxsize=None)
def jax_embeddings(jmodel, seed=0):
    """The JAX package's f32 ``embed_step`` (its body, run eagerly: a small
    model compiles slower than it runs) on ragged rows, masked."""
    v = jax_variables(jmodel, seed)
    ref = js._embed_step_impl(v["params"], v["batch_stats"], jnp.asarray(wave(seed + 2, b=3)),
                              jnp.asarray(EMBED_LENGTHS, jnp.int32), model=jmodel,
                              frontend=JaxFrontend.from_ms(), masked=True)
    return np.asarray(ref)


def check_embed_step(jmodel, tmodel, bf16: bool, seed=0):
    """The port's unit-norm ``embed_step`` (f32 or bf16 model) on ragged
    rows, masked, against the JAX package's f32 one from the same weights:
    cosine drift (1 - cos) < 1e-5 in f32, < 1e-3 in bf16."""
    load(tmodel, jax_variables(jmodel, seed))
    got = ts.embed_step(tmodel, wave(seed + 2, b=3), np.asarray(EMBED_LENGTHS, np.int32),
                        frontend=TorchFrontend.from_ms(), masked=True, device="cpu")
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-2 if bf16 else 1e-5)
    drift = 1.0 - cosine(got, jax_embeddings(jmodel, seed)).min()
    assert drift < (1e-3 if bf16 else 1e-5), drift


def check_padded_equals_solo(tmodel, solo_len, t=100, seed=1):
    """The port alone: row 0 of a masked padded batch equals the utterance's
    solo embedding (the JAX tests' tolerances, rtol 2e-4, atol 2e-5)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((1, solo_len, 80)).astype(np.float32)
    b = rng.standard_normal((1, t, 80)).astype(np.float32)
    batch = np.zeros((2, t, 80), np.float32)
    batch[0, :solo_len], batch[1] = a[0], b[0]
    mask = np.zeros((2, t), np.float32)
    mask[0, :solo_len], mask[1] = 1, 1
    tmodel.eval()
    with torch.no_grad():
        solo = tmodel(torch.from_numpy(a))
        emb = tmodel(torch.from_numpy(batch), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(emb[0].numpy(), solo[0].numpy(), rtol=2e-4, atol=2e-5)


def _assert_modules_close(got, ref, tol, floor=1e-6):
    """Every parameter and buffer: max |got - ref| <= tol * max |ref| + floor."""
    for (name, a), (_, b) in zip(got.state_dict().items(), ref.state_dict().items()):
        a, b = a.float(), b.float()
        assert (a - b).abs().max().item() <= tol * b.abs().max().item() + floor, name


def check_train_step(jmodel, make_tmodel, masked=True, seed=0):
    """One f32 SGD ``train_step`` from the same weights, masked statistics
    on ragged rows: the loss within 1e-4 relative, every parameter and
    running statistic of the backbone and the head within 5e-5 of its
    tensor's largest entry after the update."""
    jhd = jh.build_head("ce", jmodel.embedding_size, N_CLASSES)
    opt_kw = dict(name="sgd", start_lr=3e-4)
    jst = js.create_train_state(jax.random.key(seed), jmodel, jhd, js.make_optimizer(**opt_kw),
                                jnp.zeros((2, 101, 80)), N_CLASSES)
    tm, thd = make_tmodel(), th.build_head("ce", jmodel.embedding_size, N_CLASSES, device="cpu")
    load_jax_train_state(tm, thd, tree_np(jst.params), tree_np(jst.batch_stats))
    tst = ts.create_train_state(tm, thd, ts.make_optimizer(**opt_kw))
    wav = wave(seed + 3)
    lens = np.array([16000, 12000, 9000, 16000], np.int32)
    spk = np.array([0, 1, 2, 3], np.int32)
    jst, jmet = js.train_step(jst, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(spk), model=jmodel,
                              head=jhd, optimizer=js.make_optimizer(**opt_kw),
                              frontend=JaxFrontend.from_ms(), masked=masked)
    tst, tmet = ts.train_step(tst, wav, lens, spk, frontend=TorchFrontend.from_ms(), masked=masked)
    assert np.isfinite(tmet["loss"].item())
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=LOSS_RTOL)
    ref_m, ref_h = make_tmodel(), th.build_head("ce", jmodel.embedding_size, N_CLASSES, device="cpu")
    load_jax_train_state(ref_m, ref_h, tree_np(jst.params), tree_np(jst.batch_stats))
    _assert_modules_close(tst.model, ref_m, PARAM_TOL)
    _assert_modules_close(tst.head, ref_h, PARAM_TOL)


def jax_param_count(jmodel, t=200) -> int:
    """Parameter entries of the JAX model from its shapes alone (``jax.eval_shape``)."""
    v = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, t, 80))))
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(v["params"]))


def check_param_count(jmodel, tmodel):
    assert count_params(tmodel) == jax_param_count(jmodel)
