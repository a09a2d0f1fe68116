"""The port's reference ``.pth`` bridge (titanet_torch/utils/torch_compat.py)
against the JAX package's (titanet_tpu/utils/torch_compat.py) on the CPU:
a reference-layout checkpoint written by the JAX package's exporter loads
to a port model that embeds as JAX's loader + apply does, the port's
export equals JAX's key for key, and a save/load round trip keeps every
bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import cosine, small_titanet_pair
from titanet_torch.losses.heads import build_head
from titanet_torch.utils import torch_compat as tc
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.losses.heads import build_head as jax_build_head
from titanet_tpu.utils import torch_compat as jc


def _head_pair(name, n_classes=7, seed=0):
    """(JAX head params, port head) with the same weights."""
    import jax

    head = jax_build_head(name, 192, n_classes)
    params = head.init(jax.random.key(seed), jnp.zeros((2, 192)), jnp.zeros((2,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = build_head(name, 192, n_classes, device="cpu")
    load_jax_variables(port, params)
    return params, port


@pytest.mark.parametrize("overrides", [{}, {"simple_pool": True}, {"mega_block_kernel_size": 5}])
def test_reference_checkpoint_loads_to_a_port_model_that_embeds_as_jax(tmp_path, overrides):
    jmodel, variables, _ = small_titanet_pair(seed=3, **overrides)
    path = str(tmp_path / "ref.pth")
    jc.save_reference_checkpoint(path, variables["params"], variables["batch_stats"])
    model = tc.load_reference_checkpoint(path, device="cpu")
    assert model.n_mega_blocks == 2 and model.simple_pool == bool(overrides.get("simple_pool"))
    params, stats = jc.load_reference_checkpoint(path)
    x = np.random.default_rng(1).standard_normal((3, 60, 80)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert (1.0 - cosine(got, ref)).max() < 1e-5
    sd = tc.load_reference_checkpoint(path, as_model=False)
    assert set(sd) == set(model.state_dict())


def test_export_equals_jax_key_for_key():
    _, variables, tmodel = small_titanet_pair(seed=4)
    mine = tc.export_titanet_state_dict(tmodel)
    ref = jc.export_titanet_state_dict(variables["params"], variables["batch_stats"])
    assert list(mine) == list(ref)
    for k in ref:
        assert np.array_equal(mine[k], ref[k]) and mine[k].dtype == ref[k].dtype, k
    for name in ("ce", "arc", "ge2e"):
        params, port = _head_pair(name)
        mine, ref = tc.export_head_state_dict(name, port), jc.export_head_state_dict(name, params)
        assert list(mine) == list(ref)
        for k in ref:
            assert np.array_equal(mine[k], ref[k]), (name, k)
    with pytest.raises(ValueError):
        tc.export_head_state_dict("euclid", {})


@pytest.mark.parametrize("head_name", ["ce", "arc", "ge2e"])
def test_save_load_round_trip_keeps_every_bit(tmp_path, head_name):
    _, _, tmodel = small_titanet_pair(seed=5)
    _, head = _head_pair(head_name, seed=1)
    path = str(tmp_path / "port.pth")
    tc.save_reference_checkpoint(path, tmodel, head_name, head, epoch=3)
    blob = torch.load(path, weights_only=True)
    assert blob["epoch"] == 3 and blob["optimizer"] == {} and "loss_function" in "".join(blob["model"])
    model, head_sd = tc.load_reference_checkpoint(path, with_head=True, device="cpu")
    for (k, v), (k2, w) in zip(model.state_dict().items(), tmodel.state_dict().items()):
        assert k == k2 and torch.equal(v, w), k
    assert set(head_sd) == set(head.state_dict())
    for k, v in head.state_dict().items():
        assert torch.equal(head_sd[k], v), k
    fresh = build_head(head_name, 192, 7, device="cpu")
    fresh.load_state_dict(head_sd)
    params, stats, jhead = jc.load_reference_checkpoint(path, with_head=True)
    assert jhead is not None
    assert tc.load_reference_checkpoint(str(tmp_path / "port.pth"), with_head=True, as_model=False)[1].keys() \
        == head_sd.keys()


def test_a_checkpoint_without_a_head_and_a_stray_key(tmp_path):
    _, variables, _ = small_titanet_pair(seed=6)
    sd = jc.export_titanet_state_dict(variables["params"], variables["batch_stats"])
    path = str(tmp_path / "bare.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)  # bare state dict
    model, head = tc.load_reference_checkpoint(path, with_head=True, device="cpu")
    assert head is None and model.embedding_size == 192
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.load_reference_checkpoint(path)
    del sd["decoder.linear.1.running_var"]
    broken = str(tmp_path / "broken.pth")
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, broken)
    with pytest.raises(RuntimeError, match="running_var"):
        tc.load_reference_checkpoint(broken, device="cpu")
