"""Port's modules and TitaNet vs the JAX package, same weights (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import cosine, small_titanet_pair
from titanet_torch.models import titanet as tt
from titanet_torch.ops.kernels.pool import attentive_pool_fused
from titanet_torch.ops.norm import BatchNorm as TorchBN
from titanet_torch.ops.se import SqueezeExcitation as TorchSE
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.models import titanet as jt
from titanet_tpu.ops.norm import BatchNorm as JaxBN
from titanet_tpu.ops.se import SqueezeExcitation as JaxSE


def _mel(seed, b=2, t=57):
    return np.random.default_rng(seed).standard_normal((b, t, 80)).astype(np.float32)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_small_titanet_matches_jax(dtype):
    """Embedding cosine drift < 1e-3 in f32 and bf16 (bf16 also takes the
    fused decoder route: epilog BN folded into the pooling kernel's plain
    version)."""
    jmodel, variables, tmodel = small_titanet_pair(dtype)
    x = _mel(0)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False).astype(jnp.float32))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x)).float().numpy()
    drift = 1.0 - cosine(out, ref)
    assert drift.max() < (1e-5 if dtype is None else 1e-3), drift


def test_small_titanet_masked_matches_jax():
    jmodel, variables, tmodel = small_titanet_pair(None, seed=1)
    x = _mel(1)
    mask = np.ones((2, 57), np.float32)
    mask[1, 30:] = 0.0
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False, mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    assert (1.0 - cosine(out, ref)).max() < 1e-5


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_simple_pool_titanet_matches_jax(dtype, masked):
    """simple_pool: average pool + Linear(C -> 2C) in place of attentive
    pooling and its BatchNorm; the weight bridge fills it by path."""
    jmodel, variables, tmodel = small_titanet_pair(dtype, seed=3, simple_pool=True)
    assert "pool_norm" not in variables["params"]["decoder"]
    assert not hasattr(tmodel.decoder, "pool_norm")
    x = _mel(4)
    mask = np.ones((2, 57), np.float32)
    mask[1, 30:] = 0.0
    mj = jnp.asarray(mask) if masked else None
    mt = torch.from_numpy(mask) if masked else None
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False, mask=mj).astype(jnp.float32))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), mask=mt).float().numpy()
    drift = 1.0 - cosine(out, ref)
    assert drift.max() < (1e-5 if dtype is None else 1e-3), drift


def test_simple_pool_param_count_matches_jax():
    model = tt.TitaNet(n_mega_blocks=3, simple_pool=True)
    n = sum(p.numel() for p in model.parameters())
    assert n == jt.titanet_param_count(n_mega_blocks=3, simple_pool=True)
    assert n == tt.titanet_param_count(n_mega_blocks=3, simple_pool=True)
    assert tt.find_n_mega_blocks(simple_pool=True) == jt.find_n_mega_blocks(simple_pool=True)
    assert tt.get_titanet(n_mega_blocks=1, simple_pool=True, device="cpu").simple_pool


def test_bf16_titanet_routes_through_pool_wrapper(monkeypatch):
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return attentive_pool_fused(*args, **kw)

    monkeypatch.setattr("titanet_torch.ops.pooling.attentive_pool_fused", spy)
    _, _, tmodel = small_titanet_pair(torch.bfloat16)
    with torch.no_grad():
        tmodel(torch.from_numpy(_mel(2)))
        assert len(calls) == 1
        tmodel(torch.from_numpy(_mel(2)), mask=torch.ones(2, 57))
        assert len(calls) == 1  # a mask keeps the plain path
    _, _, f32model = small_titanet_pair(None)
    with torch.no_grad():
        f32model(torch.from_numpy(_mel(2)))
    assert len(calls) == 1  # f32 is the parity surface: plain path


@pytest.mark.parametrize("size", ["s", "m", "l"])
def test_param_count_matches_jax(size):
    preset = tt._SIZE_PRESETS[size]
    model = tt.TitaNet(n_mega_blocks=17, **preset)
    n = sum(p.numel() for p in model.parameters())
    ref = jt.titanet_param_count(
        n_mega_blocks=17, hidden=preset["encoder_hidden_size"],
        kernel=preset["mega_block_kernel_size"],
    )
    assert n == ref == tt.titanet_param_count(
        n_mega_blocks=17, hidden=preset["encoder_hidden_size"],
        kernel=preset["mega_block_kernel_size"],
    )
    assert tt.find_n_mega_blocks(model_size=size) == jt.find_n_mega_blocks(model_size=size)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_eval_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    bn = JaxBN(use_running_average=True, dtype=jdt)
    v = jax.tree_util.tree_map(np.asarray, dict(bn.init(jax.random.key(0), jnp.asarray(x))))
    v["params"] = {"scale": rng.uniform(0.5, 2, 64).astype(np.float32),
                   "bias": rng.standard_normal(64).astype(np.float32)}
    v["batch_stats"] = {"mean": rng.standard_normal(64).astype(np.float32),
                        "var": rng.uniform(0.5, 2, 64).astype(np.float32)}
    port = TorchBN(64, dtype=dtype).eval()
    load_jax_variables(port, v["params"], v["batch_stats"])
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dtype)
    ref = np.asarray(bn.apply(v, xj).astype(jnp.float32))
    a_j, c_j = bn.apply(v, xj, return_scale_shift=True)
    with torch.no_grad():
        np.testing.assert_allclose(port(xt).float().numpy(), ref, rtol=1e-6, atol=1e-6)
        a_t, c_t = port(xt, return_scale_shift=True)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_squeeze_excitation_matches_jax(masked):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 11, 64)).astype(np.float32)
    mask = (np.arange(11)[None, :] < np.array([[11], [6], [1]])).astype(np.float32)
    se = JaxSE(reduction=16)
    v = jax.tree_util.tree_map(np.asarray, dict(se.init(jax.random.key(0), jnp.asarray(x))))
    port = TorchSE(64, 16)
    load_jax_variables(port, v["params"])
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    ref = np.asarray(se.apply(v, jnp.asarray(x), mask=m_j))
    with torch.no_grad():
        out = port(torch.from_numpy(x), mask=m_t).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_weight_bridge_rejects_mismatched_trees():
    _, variables, tmodel = small_titanet_pair(None)
    params = dict(variables["params"])
    params["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError):
        load_jax_variables(tmodel, params, variables["batch_stats"])
    bad = jax.tree_util.tree_map(lambda a: a, variables["params"])
    bad["decoder"]["linear"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_jax_variables(tmodel, bad, variables["batch_stats"])


def test_batchnorm_refuses_training_mode():
    """Training mode is ported (tests/test_torch_train.py); what it refuses
    is a mask that does not cover the statistics' axes."""
    bn = TorchBN(8).train()
    with pytest.raises(ValueError):
        bn(torch.zeros(2, 5, 8), mask=torch.ones(2, 4))
    assert bn(torch.zeros(2, 5, 8), mask=torch.ones(2, 5)).shape == (2, 5, 8)
