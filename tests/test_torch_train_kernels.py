"""The training path's kernels (plain versions on the CPU) vs the Pallas
kernels they replace, run in interpret mode: the attentive-pool backward
(titanet_tpu/ops/pallas/pool.py::_bwd_impl) and the depthwise-conv backward
(titanet_tpu/ops/pallas/dwconv.py::_dw_bwd_pallas). The CUDA kernels are
held against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.ops import conv as tconv
from titanet_torch.ops.kernels import dwconv
from titanet_torch.ops.kernels.pool import (
    attentive_pool_bwd,
    attentive_pool_bwd_plain,
    attentive_pool_fused,
)
from titanet_tpu.ops.pallas import dwconv as jdwconv
from titanet_tpu.ops.pallas import pool as jpool

POOL_NAMES = ("h", "a", "c", "wa", "ba", "wb", "bb")


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _pool_inputs(seed, b, t, c=128, h=128):
    rng = np.random.default_rng(seed)
    x = dict(
        h=rng.standard_normal((b, t, c)),
        a=rng.uniform(0.5, 1.5, (c,)),
        c=rng.standard_normal((c,)) * 0.2,
        wa=rng.standard_normal((c, h)) * 0.05,
        ba=rng.standard_normal((h,)) * 0.05,
        wb=rng.standard_normal((h, c)) * 0.05,
        bb=rng.standard_normal((c,)) * 0.05,
    )
    x = {k: v.astype(np.float32) for k, v in x.items()}
    return x, rng.standard_normal((b, 2 * c)).astype(np.float32)


def _jax_pool_grads(x, g, fold, dtype):
    args = [jnp.asarray(x[k]) for k in POOL_NAMES]
    args[0] = args[0].astype(dtype)
    _, vjp = jax.vjp(lambda *a: jpool.attentive_pool_fused(*a, 1e-6, 2, fold), *args)
    grads = vjp(jnp.asarray(g).astype(dtype))
    return [np.asarray(v.astype(jnp.float32)) for v in grads]


def _torch_pool_grads(x, g, fold, dtype):
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
    h = t["h"].to(dtype).detach().requires_grad_()
    out = attentive_pool_fused(h, *(t[k] for k in POOL_NAMES[1:]), 1e-6, fold)
    out.backward(torch.from_numpy(g).to(dtype))
    return [h.grad.float().numpy()] + [t[k].grad.numpy() for k in POOL_NAMES[1:]]


# f32: the JAX test's own limit for the kernel's gradients (2e-4). bf16: dh
# is stored in bf16 (one ulp is 2^-8 of the value) and both round de and dz
# to bf16 before the products, where a rounding that falls the other way
# moves a product by one bf16 ulp: 2e-2 of each gradient's largest entry.
# dbb is zero in exact arithmetic (softmax over T ignores a per-channel
# shift), so both sides are rounding noise: held below the same fraction of
# dWb's largest entry (dWb sums the same de over the same rows).
@pytest.mark.parametrize("t", [13, 301])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_backward_matches_pallas_kernel(dtype, fold, t):
    x, g = _pool_inputs(10 + t + fold, b=2, t=t)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ref = _jax_pool_grads(x, g, fold, jdt)
    out = _torch_pool_grads(x, g, fold, tdt)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, o, r in zip(POOL_NAMES, out, ref):
        if name in ("a", "c") and not fold:
            assert not np.any(o) and not np.any(r), name
            continue
        if name == "bb":
            scale = np.abs(ref[POOL_NAMES.index("wb")]).max()
            np.testing.assert_allclose(o, 0.0, atol=tol * scale, err_msg=name)
            np.testing.assert_allclose(r, 0.0, atol=tol * scale, err_msg=name)
            continue
        scale = np.abs(r).max()
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol * scale, err_msg=name)


def test_pool_function_gradients_match_autograd_of_plain_forward():
    """The Function's backward (plain kernel arithmetic) equals autograd
    through the plain forward, f32."""
    from titanet_torch.ops.kernels.pool import attentive_pool_fwd_plain

    x, g = _pool_inputs(3, b=3, t=17)
    for fold in (False, True):
        t1 = {k: torch.from_numpy(v).double().requires_grad_() for k, v in x.items()}
        out = attentive_pool_fwd_plain(*(t1[k] for k in POOL_NAMES), 1e-6, fold)
        out.backward(torch.from_numpy(g).double())
        ref = [np.zeros(x[k].shape, np.float32) if t1[k].grad is None else t1[k].grad.float().numpy()
               for k in POOL_NAMES]
        got = _torch_pool_grads(x, g, fold, torch.float32)
        for name, o, r in zip(POOL_NAMES, got, ref):
            if name == "bb" or (name in ("a", "c") and not fold):
                continue
            np.testing.assert_allclose(o, r, rtol=2e-4, atol=2e-4 * np.abs(r).max(), err_msg=name)


def test_pool_bwd_wrapper_checks_inputs_and_counts_no_launch_on_cpu():
    x, g = _pool_inputs(4, b=2, t=5)
    args = [torch.from_numpy(x[k]) for k in POOL_NAMES]
    gt = torch.from_numpy(g)
    before = attentive_pool_bwd.launches
    got = attentive_pool_bwd(*args, gt, 1e-6, True)
    ref = attentive_pool_bwd_plain(*args, gt, 1e-6, True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert attentive_pool_bwd.launches == before
    with pytest.raises(ValueError):
        attentive_pool_bwd(*args, gt[:, :5].contiguous(), 1e-6, True)
    with pytest.raises(ValueError):
        attentive_pool_bwd(*args, gt.t().contiguous().t(), 1e-6, True)


def _dw_inputs(k, dtype, b=3, t=37, c=128, seed=0):
    rng = np.random.default_rng(seed + k)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((k, 1, c)) * 0.3).astype(np.float32)  # JAX WIO [K, 1, C]
    dy = rng.standard_normal((b, t, c)).astype(np.float32)
    return x, w, dy


# tests/test_pallas_melspec.py's tolerances for the kernel's gradients:
# 1e-5 (f32) and 3e-2 (bf16) relative, and that fraction of the largest entry.
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_bwd_plain_matches_pallas_kernel(k, dtype):
    x, w, dy = _dw_inputs(k, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rdx, rdk, rdb = jdwconv._dw_bwd_pallas(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(dy).astype(jdt)
    )
    weight = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 1, 0))))  # [C, 1, K]
    dx, dk, db = dwconv.dw_bwd_plain(
        torch.from_numpy(x).to(tdt), weight, torch.from_numpy(dy).to(tdt)
    )
    assert dx.dtype == tdt and dk.shape == (128, 1, k) and db.shape == (128,)
    tol = 1e-5 if dtype == "float32" else 3e-2
    pairs = (
        ("dx", dx.float().numpy(), np.asarray(rdx.astype(jnp.float32))),
        ("dk", dk.numpy(), np.transpose(np.asarray(rdk), (2, 1, 0))),
        ("db", db.numpy(), np.asarray(rdb)),
    )
    for name, a, e in pairs:
        np.testing.assert_allclose(a, e, rtol=tol, atol=tol * np.abs(e).max(), err_msg=name)


@pytest.mark.parametrize("k", [3, 7])
def test_depthwise_function_gradients_match_library_conv(k):
    """f32: the Function's gradients (plain backward on the CPU) equal
    autograd through the library grouped conv."""
    x, w, dy = _dw_inputs(k, "float32", seed=5)
    weight = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 1, 0))))
    bias = torch.from_numpy(np.linspace(-0.1, 0.1, 128, dtype=np.float32))
    grads = []
    for fn in (dwconv.depthwise_conv1d_fused_bwd,
               lambda x, w, b: tconv.conv1d_same(x, w, b, groups=x.shape[-1])):
        xs, ws, bs = (torch.from_numpy(x).requires_grad_(), weight.clone().requires_grad_(),
                      bias.clone().requires_grad_())
        out = fn(xs, ws, bs)
        out.backward(torch.from_numpy(dy))
        grads.append((out.detach(), xs.grad, ws.grad, bs.grad))
    for a, e in zip(*grads):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


def test_dw_bwd_routing_env(monkeypatch):
    """TITANET_DW_BWD=pallas routes an eligible bf16 depthwise conv to the
    Function (its backward runs dw_bwd once); the default, xla, keeps the
    library conv's backward. Outputs are equal either way."""
    mod = tconv.SamePadConv1d(128, 128, 3, groups=128, dtype=torch.bfloat16)
    x = torch.ones(2, 16, 128, dtype=torch.bfloat16)
    calls = []
    real = dwconv.dw_bwd
    monkeypatch.setattr(dwconv, "dw_bwd", lambda *a: calls.append(1) or real(*a))
    monkeypatch.delenv("TITANET_DW_BWD", raising=False)
    assert tconv.dw_bwd_mode() == "xla"
    y_xla = mod(x)
    y_xla.float().sum().backward()
    assert not calls
    monkeypatch.setenv("TITANET_DW_BWD", "pallas")
    y_pallas = mod(x)
    y_pallas.float().sum().backward()
    assert len(calls) == 1
    torch.testing.assert_close(y_pallas, y_xla, rtol=0, atol=0)
    # f32 and unaligned channels keep the library backward under pallas too
    mod32 = tconv.SamePadConv1d(128, 128, 3, groups=128)
    mod32(torch.ones(2, 16, 128)).sum().backward()
    assert len(calls) == 1


def test_dw_kernel_supports_matches_jax_rule():
    for t, c, k in ((301, 256, 3), (301, 200, 3), (301, 256, 4), (5000, 256, 3), (0, 256, 3), (7, 128, 11)):
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            assert dwconv.kernel_supports(t, c, k, tdt) == jdwconv.kernel_supports(t, c, k, jdt)


@pytest.mark.parametrize("k", [13, 31])
def test_dw_wider_than_the_kernel_keeps_the_library_backward(monkeypatch, k):
    """The kernel is built for K <= 11 (every TitaNet preset). Wider odd K,
    which the JAX rule would send to its kernel, keeps the library conv's
    backward under TITANET_DW_BWD=pallas, so the router never sends the
    wrapper a shape it refuses."""
    assert jdwconv.kernel_supports(301, 128, k, jnp.bfloat16)
    assert not dwconv.kernel_supports(301, 128, k, torch.bfloat16)
    mod = tconv.SamePadConv1d(128, 128, k, groups=128, dtype=torch.bfloat16)
    calls = []
    real = dwconv.dw_bwd
    monkeypatch.setattr(dwconv, "dw_bwd", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("TITANET_DW_BWD", "pallas")
    x = torch.ones(2, 16, 128, dtype=torch.bfloat16, requires_grad=True)
    mod(x).float().sum().backward()
    assert not calls and x.grad is not None and mod.weight.grad is not None
