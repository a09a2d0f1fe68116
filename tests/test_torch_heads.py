"""Port's heads (titanet_torch/losses/heads.py) vs titanet_tpu.losses.heads
on the same parameters and inputs (CPU, f32): loss, predictions and the
gradients of the loss to the embeddings and to every head parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.losses import heads as th
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.losses import heads as jh

E, N, B = 16, 5, 8

CASES = {
    "ce": ("ce", {}, {}),
    "arc": ("arc", {}, {}),
    "cos": ("cos", {}, {}),
    "sphere": ("sphere", {}, {}),
    "arc_unstable": ("arc", {"stable": False, "scale": 30.0}, {}),
    "arc_subcenters": ("arc", {"sub_centers": 3}, {}),
    "arc_margin_scale": ("arc", {}, {"margin_scale": 0.4}),
    "sphere_norm_scale": ("sphere", {"scale": None, "margin": 2.0}, {}),
    "ge2e": ("ge2e", {}, {}),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    # every class present twice but one (a single-utterance speaker exercises
    # GE2E's all-zero leave-one-out centroid)
    targets = np.array([0, 0, 1, 1, 2, 2, 3, 4], np.int32)
    return emb, targets


def _pair(loss_name, kwargs, seed=0):
    jhead = jh.build_head(loss_name, E, N, **kwargs)
    emb, targets = _inputs(seed)
    params = jhead.init(jax.random.key(seed), jnp.asarray(emb), jnp.asarray(targets))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    if loss_name == "ge2e":  # off the init values, so w and b both matter
        params = {"w": np.float32(1.7), "b": np.float32(-0.3)}
    thead = th.build_head(loss_name, E, N, device="cpu", **kwargs)
    load_jax_variables(thead, params)
    return jhead, params, thead, emb, targets


@pytest.mark.parametrize("case", sorted(CASES))
def test_head_matches_jax(case):
    loss_name, kwargs, call_kw = CASES[case]
    jhead, params, thead, emb, targets = _pair(loss_name, kwargs)

    def jloss(p, e):
        _, _, loss = jhead.apply({"params": p}, e, jnp.asarray(targets), **call_kw)
        return loss

    j_norm, j_preds, j_loss = jhead.apply({"params": params}, jnp.asarray(emb), jnp.asarray(targets), **call_kw)
    j_gp, j_ge = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(emb))

    e_t = torch.from_numpy(emb).requires_grad_()
    t_norm, t_preds, t_loss = thead(e_t, torch.from_numpy(targets), **call_kw)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(t_norm.detach().numpy(), np.asarray(j_norm), rtol=1e-5, atol=1e-6)
    if j_preds is None:
        assert t_preds is None
    else:
        np.testing.assert_array_equal(t_preds.numpy(), np.asarray(j_preds))
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(j_ge), rtol=1e-4, atol=1e-6)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(j_gp)[0]}
    got = {}
    for name, p in thead.named_parameters():
        key = {"fc.weight": "fc/kernel", "fc.bias": "fc/bias"}.get(name, name)
        g = p.grad.numpy()
        got[key] = g.T if name == "fc.weight" else g
    assert sorted(got) == sorted(flat)
    for key, g in got.items():
        np.testing.assert_allclose(g, flat[key], rtol=1e-4, atol=1e-6, err_msg=key)


def test_renormalize_params_matches_jax():
    jhead, params, thead, _, _ = _pair("arc", {"sub_centers": 2})
    ref = jh.renormalize_params(dict(params))["weight"]
    th.renormalize_params(thead)
    np.testing.assert_allclose(thead.weight.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    ce = _pair("ce", {})[2]
    before = [p.detach().clone() for p in ce.parameters()]
    th.renormalize_params(ce)
    assert all(torch.equal(a, b) for a, b in zip(before, ce.parameters()))


@pytest.mark.parametrize("name", ["ce", "arc", "cos", "sphere", "ge2e"])
def test_head_param_count_matches_jax_and_module(name):
    for k in (1, 3):
        if name != "arc" and k > 1:
            continue
        kw = {"sub_centers": k} if k > 1 else {}
        head = th.build_head(name, E, N, device="cpu", **kw)
        n = sum(p.numel() for p in head.parameters())
        assert n == th.head_param_count(name, E, N, k) == jh.head_param_count(name, E, N, k)


def test_build_head_rejects_bad_margins_and_names():
    with pytest.raises(ValueError):
        th.build_head("arc", E, N, device="cpu", margin=1.5)
    with pytest.raises(ValueError):
        th.build_head("sphere", E, N, device="cpu", margin=1.0)
    with pytest.raises(ValueError):
        th.build_head("triplet", E, N, device="cpu")
