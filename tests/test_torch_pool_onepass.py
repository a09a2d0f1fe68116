"""The one-pass pool forward's decomposition (``pool_onepass_kernel`` in
``titanet_torch/csrc/attn_pool.cu``), run in plain torch
(``attentive_pool_fwd_split``: tiles of R frames, each cut into the two
warpgroups' halves, T split into parts whose running softmax states are
merged in the kernel's order), held against the JAX package's fused pooling
(the Pallas kernel in interpret mode off the TPU) and against
``attentive_pool_fwd_plain``. The kernel itself is held on the card in
tests/test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.ops.kernels import pool as pk
from titanet_tpu.ops.pallas.pool import attentive_pool_fused

C, H = 256, 128
TS = [1, 7, 64, 65, 200]
# (R, parts): the kernel's tiles of 128 frames, and small tiles that give
# T = 200 up to 25 tiles, so that every part walks several
SPLITS = [(128, 1), (128, 2), (16, 1), (16, 3), (8, 2)]


def _inputs(t, seed, b=2):
    rng = np.random.default_rng(seed)
    return dict(
        h=rng.standard_normal((b, t, C)).astype(np.float32),
        a=rng.uniform(0.5, 1.5, (C,)).astype(np.float32),
        c=(rng.standard_normal((C,)) * 0.2).astype(np.float32),
        wa=(rng.standard_normal((C, H)) * 0.05).astype(np.float32),
        ba=(rng.standard_normal((H,)) * 0.05).astype(np.float32),
        wb=(rng.standard_normal((H, C)) * 0.05).astype(np.float32),
        bb=(rng.standard_normal((C,)) * 0.05).astype(np.float32),
    )


def _torch_args(x, dtype):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return (t["h"].to(dtype), t["a"], t["c"], t["wa"].to(dtype), t["ba"], t["wb"].to(dtype), t["bb"])


@functools.lru_cache(maxsize=None)
def _case(t, fold, bf16):
    """Inputs and the JAX package's output (f32 numpy) of one case."""
    x = _inputs(t, seed=t + 100 * fold)
    args = [jnp.asarray(x[k]) for k in ("h", "a", "c", "wa", "ba", "wb", "bb")]
    if bf16:
        args[0], args[3], args[5] = (args[i].astype(jnp.bfloat16) for i in (0, 3, 5))
    ref = np.asarray(attentive_pool_fused(*args, 1e-6, 2, fold).astype(jnp.float32))
    return x, ref


@pytest.mark.parametrize("rows,splits", SPLITS)
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("t", TS)
def test_split_matches_jax_and_plain_f32(t, fold, rows, splits):
    x, ref = _case(t, fold, False)
    args = _torch_args(x, torch.float32)
    got = pk.attentive_pool_fwd_split(*args, 1e-6, fold, rows=rows, splits=splits).numpy()
    plain = pk.attentive_pool_fwd_plain(*args, 1e-6, fold).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,splits", [(128, 1), (16, 3)])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("t", TS)
def test_split_matches_jax_and_plain_bf16(t, fold, rows, splits):
    """bf16 operands: y and u rounded to bf16 before the products, as the
    Pallas kernel and the plain version round them (the tolerance of
    tests/test_torch_kernels.py::test_pool_plain_matches_pallas_kernel_bf16)."""
    x, ref = _case(t, fold, True)
    args = _torch_args(x, torch.bfloat16)
    got = pk.attentive_pool_fwd_split(*args, 1e-6, fold, rows=rows, splits=splits).float().numpy()
    plain = pk.attentive_pool_fwd_plain(*args, 1e-6, fold).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, plain, rtol=2e-2, atol=2e-2)


def test_parts_past_the_last_tile_hold_empty_states():
    """More parts than tiles (the kernel's splits of a small batch): the
    empty parts add nothing, bit for bit."""
    x, _ = _case(7, True, False)
    args = _torch_args(x, torch.float32)
    one = pk.attentive_pool_fwd_split(*args, 1e-6, True, splits=1)
    many = pk.attentive_pool_fwd_split(*args, 1e-6, True, splits=5)
    assert torch.equal(one, many)


@pytest.mark.parametrize("b,want", [(128, 1), (64, 2), (66, 2), (65, 2), (4, 33), (2, 64), (1, 64), (200, 1)])
def test_splits_fill_an_h100(b, want):
    """Blocks an utterance: 132 // B (one block an SM of an H100) within
    [1, 64], a mirror of csrc/attn_pool.cu::onepass_splits."""
    assert pk.onepass_splits(b) == want
    assert b * pk.onepass_splits(b) <= max(b, pk.ONEPASS_BLOCK_TARGET)


@pytest.mark.parametrize("b,t", [(128, 301), (4, 151), (1, 1)])
def test_bf16_backward_workspace_holds_the_first_stages_states(b, t, monkeypatch):
    """The bf16 tensor-core backward's workspace holds the running states
    of its first stage (the one-pass forward): 2 S x 4 x B x C floats, S
    from onepass_splits; the FP32-core route holds none."""
    c = 1536
    bf16, f32 = pk.bwd_workspace_bytes(b, t, c, 128, 2), pk.bwd_workspace_bytes(b, t, c, 128, 4)
    splits = pk.onepass_splits(b)
    monkeypatch.setattr(pk, "onepass_splits", lambda _b: splits + 1)
    assert pk.bwd_workspace_bytes(b, t, c, 128, 2) - bf16 == 2 * 4 * b * c * 4
    assert pk.bwd_workspace_bytes(b, t, c, 128, 4) == f32
