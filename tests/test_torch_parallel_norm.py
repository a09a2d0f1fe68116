"""The port's synchronized BatchNorm (``titanet_torch.ops.norm`` under an
active mesh) vs the JAX module, on the CPU.

Two ranks (gloo, spawned once for the module) each normalize their rows of
a batch whose masks have unequal valid lengths:

- the global-batch rule equals JAX's ``BatchNorm`` on the concatenated
  batch: output, input gradient, scale/bias gradients (summed over the
  ranks), fold vectors and the running statistics updated from the
  published moments, on every rank; also with a mean of 300, where
  ``E[x^2] - mean^2`` would miss the variance by ~1e-3 in f32 (there
  ``x - mean`` rounds at 300's ulp, 3e-5, in both frameworks, so the
  output and the gradients are held to 2e-4: the output of each is within
  6e-5 of a float64 evaluation; the variance stays at 1e-5);
- the ``axis_name`` rule equals JAX's pmean rule (the module under
  ``jax.vmap`` with ``axis_name``). That rule scales the local frame
  count by P for the unbiased variance, so with unequal masks each rank
  (as each JAX shard) publishes another running variance;
- at world size 1 the layer and the train step are the local ones, bit for
  bit, and issue no collective.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.torch_parallel_helpers import free_port, run_worker_ranks
from titanet_tpu.ops.norm import BatchNorm as JaxBN

C = 64
LENGTHS = [11, 6, 3, 9]  # rows 0-1 on rank 0, rows 2-3 on rank 1
TOL = 1e-5


def _case(offset: float, masked: bool, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 11, C)) * 2 + 0.5 + offset).astype(np.float32)
    mask = (np.arange(11)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)
    return {"x": x, "mask": mask if masked else None, "g": rng.standard_normal(x.shape).astype(np.float32),
            "scale": rng.uniform(0.5, 2, C).astype(np.float32), "bias": rng.standard_normal(C).astype(np.float32),
            "mean": rng.standard_normal(C).astype(np.float32), "var": rng.uniform(0.5, 2, C).astype(np.float32)}


CASES = {"masked": _case(0.0, True, 0), "unmasked": _case(0.0, False, 1), "mean_300": _case(300.0, True, 2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_worker_ranks("norm", {"bn": CASES}, tmp_path_factory.mktemp("norm"))


def _jax_reference(case, axis_name=None):
    """JAX on the concatenated batch (``axis_name``: two shards of two rows
    under ``jax.vmap``, the shard_map rule): ``(y, dx, dscale, dbias,
    running mean, running var, a, c)`` as numpy, shards concatenated."""
    params = {"scale": jnp.asarray(case["scale"]), "bias": jnp.asarray(case["bias"])}
    stats = {"mean": jnp.asarray(case["mean"]), "var": jnp.asarray(case["var"])}
    x, g = jnp.asarray(case["x"]), jnp.asarray(case["g"])
    mask = None if case["mask"] is None else jnp.asarray(case["mask"])
    bn = JaxBN(use_running_average=False, axis_name=axis_name)

    def apply(p, xx, mm, **kw):
        return bn.apply({"params": p, "batch_stats": stats}, xx, mask=mm, mutable=["batch_stats"], **kw)

    if axis_name is None:
        run = apply
    else:
        def run(p, xx, mm, **kw):
            split = lambda a: None if a is None else a.reshape((2, 2) + a.shape[1:])  # noqa: E731
            out = jax.vmap(lambda xs, ms: apply(p, xs, ms, **kw), in_axes=(0, None if mm is None else 0),
                           axis_name=axis_name)(split(xx), split(mm))
            # rows of the shards concatenated; [2, C] statistics kept a shard
            return jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]) if a.ndim > 2 else a, out)

    def loss(p, xx):
        return jnp.sum(run(p, xx, mask)[0] * g)

    y, upd = run(params, x, mask)
    (a, c), _ = run(params, x, mask, return_scale_shift=True)
    if axis_name is not None:
        a, c = a[0], c[0]
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    return [np.asarray(v) for v in (y, gx, gp["scale"], gp["bias"], upd["batch_stats"]["mean"],
                                    upd["batch_stats"]["var"], a, c)]


def _check_against_jax(results, name, ref, tol_x=TOL):
    y, dx, dscale, dbias, r_mean, r_var, a, c = ref
    got = [r[name] for r in results]
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), y, rtol=tol_x, atol=tol_x)
    np.testing.assert_allclose(torch.cat([g["dx"] for g in got]).numpy(), dx, rtol=tol_x,
                               atol=tol_x * np.abs(dx).max())
    for key, want in (("dscale", dscale), ("dbias", dbias)):
        np.testing.assert_allclose(sum(g[key] for g in got).numpy(), want, rtol=tol_x,
                                   atol=tol_x * np.abs(want).max())
    for key, want in (("running_mean", r_mean), ("running_var", r_var), ("a", a), ("c", c)):
        if want.ndim == 1:
            # the ranks combine the same gathered moments in the same order
            assert torch.equal(got[0][key], got[1][key]), key
            want = np.stack([want, want])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[key].numpy(), w, rtol=TOL, atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("name", list(CASES))
def test_global_batch_rule_over_two_ranks_matches_jax_on_the_concatenated_batch(ranks, name):
    _check_against_jax(ranks, name, _jax_reference(CASES[name]), tol_x=2e-4 if name == "mean_300" else TOL)


@pytest.mark.parametrize("name", ["masked", "unmasked"])
def test_axis_name_rule_matches_the_jax_pmean_rule(ranks, name):
    if name == "masked":
        var = [r[name + "/axis_name"]["running_var"] for r in ranks]
        assert not torch.equal(*var)  # rank 0 counts 17 valid frames, rank 1 counts 12
    _check_against_jax(ranks, name + "/axis_name", _jax_reference(CASES[name], axis_name="data"))


def test_world_size_one_is_the_local_path_bit_for_bit():
    """A gloo group of one rank: BatchNorm under the active mesh, both
    rules, and two train steps with dropout and SpecAugment under
    ``mesh=`` give the bits of the code without a mesh, and no collective
    is issued; ``make_mesh(2)`` refuses a group of one."""
    from tests.torch_parallel_worker import toy_state
    from titanet_torch.ops.frontend import FrontendConfig
    from titanet_torch.ops.norm import BatchNorm
    from titanet_torch.parallel import make_mesh
    from titanet_torch.parallel.distributed import collective_stats, reset_collective_stats
    from titanet_torch.train import state as ts

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.size == 1 and mesh.rank == 0
        with pytest.raises(ValueError, match="process group of 2 ranks"):
            make_mesh(2, device="cpu")
        reset_collective_stats()
        case = CASES["masked"]
        for axis_name in (None, "data"):
            outs = []
            for use_mesh in (False, True):
                bn = BatchNorm(C, axis_name=axis_name).train()
                x = torch.from_numpy(case["x"]).requires_grad_()
                with mesh.active() if use_mesh else torch.enable_grad():
                    y = bn(x, mask=torch.from_numpy(case["mask"]))
                (y * torch.from_numpy(case["g"])).sum().backward()
                outs.append((y, x.grad, bn.weight.grad, *bn.batch_moments))
            for a, b in zip(*outs):
                assert torch.equal(a, b)
        fe = FrontendConfig.from_ms()
        rng = np.random.default_rng(3)
        wav = (rng.standard_normal((4, 8000)) * 0.1).astype(np.float32)
        lengths, spk = np.array([8000, 6000, 7000, 5000], np.int32), np.array([0, 1, 2, 3], np.int32)
        plain, meshed = toy_state(), toy_state()
        for _ in range(2):
            _, m0 = ts.train_step(plain, wav, lengths, spk, frontend=fe, augment=(0.35, 1, 0.15, 1, 1.0))
            _, m1 = ts.train_step(meshed, wav, lengths, spk, frontend=fe, augment=(0.35, 1, 0.15, 1, 1.0),
                                  mesh=mesh)
            assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
        for a, b in zip(plain.model.state_dict().values(), meshed.model.state_dict().values()):
            assert torch.equal(a, b)
        assert collective_stats()["count"] == 0
    finally:
        dist.destroy_process_group()
