"""The scan layout of the mega-block weights (JAX ``TitaNet(scan_blocks=True)``):
the port's ``stack_mega_block_params`` / ``unstack_mega_block_params`` vs
the JAX package's, and ``load_jax_variables`` filling the port's TitaNet
from a scan tree (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import cosine
from titanet_torch.models import stack_mega_block_params, unstack_mega_block_params
from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.utils.weights import load_jax_train_state, load_jax_variables
from titanet_tpu.models import stack_mega_block_params as jax_stack
from titanet_tpu.models import unstack_mega_block_params as jax_unstack
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet

TOY = dict(n_mega_blocks=3, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
           attention_hidden_size=8, dropout=0.0)  # tests/test_scan_blocks.py's widths


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x, y), path


@pytest.fixture(scope="module")
def unrolled_tree():
    model = JaxTitaNet(**TOY)
    x = jnp.zeros((1, 16, 80), jnp.float32)
    return _numpy_tree(model.init(jax.random.key(0), x))


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_stack_and_unstack_equal_jax_to_the_bit(unrolled_tree, collection):
    tree = unrolled_tree[collection]
    stacked = stack_mega_block_params(tree, 3)
    _same(stacked, _numpy_tree(jax_stack(tree, 3)))
    assert "mega_block_0" not in stacked["encoder"]
    assert all(np.shape(x)[0] == 3 for _, x in _leaves(stacked["encoder"]["mega_blocks"]))
    back = unstack_mega_block_params(stacked)
    _same(back, _numpy_tree(jax_unstack(_numpy_tree(jax_stack(tree, 3)))))
    _same(back, tree)  # round trip


def test_stack_and_unstack_take_tensors(unrolled_tree):
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), unrolled_tree["params"])
    stacked = stack_mega_block_params(tree, 3)
    leaf = stacked["encoder"]["mega_blocks"]["block"]["sub_block_0"]["conv"]["depthwise"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.shape[0] == 3
    back = unstack_mega_block_params(stacked)
    _same(jax.tree_util.tree_map(lambda t: t.numpy(), back), unrolled_tree["params"])


def _scan_pair(seed=0):
    """A JAX scan-layout TitaNet with random BatchNorm statistics, and the
    port's TitaNet of the same widths filled from its tree."""
    rng = np.random.default_rng(seed)
    jmodel = JaxTitaNet(scan_blocks=True, **TOY)
    variables = _numpy_tree(jmodel.init(jax.random.key(seed), jnp.zeros((1, 16, 80), jnp.float32)))

    def stats(tree):
        if "mean" in tree and not isinstance(tree["mean"], dict):
            return {"mean": (rng.standard_normal(tree["mean"].shape) * 0.1).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, tree["var"].shape).astype(np.float32)}
        return {k: stats(v) for k, v in tree.items()}

    variables["batch_stats"] = stats(variables["batch_stats"])
    assert "mega_blocks" in variables["params"]["encoder"]
    tmodel = TorchTitaNet(**TOY).eval()
    load_jax_variables(tmodel, variables["params"], variables["batch_stats"])
    return jmodel, variables, tmodel


@pytest.mark.parametrize("masked", [False, True])
def test_scan_tree_loads_and_matches_jax_scan_model(masked):
    """Embeddings of the port's model filled from a JAX scan tree vs the JAX
    scan model on the same mel: cosine drift < 1e-5 (the f32 budget)."""
    jmodel, variables, tmodel = _scan_pair()
    x = np.random.default_rng(1).standard_normal((2, 57, 80)).astype(np.float32)
    mask = np.ones((2, 57), np.float32)
    mask[1, 30:] = 0.0
    jmask = jnp.asarray(mask) if masked else None
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False, mask=jmask))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), mask=torch.from_numpy(mask) if masked else None).numpy()
    drift = 1.0 - cosine(out, ref)
    assert drift.max() < 1e-5, drift


def test_scan_tree_fills_the_same_weights_as_the_unrolled_tree():
    _, variables, tmodel = _scan_pair(seed=2)
    unrolled = TorchTitaNet(**TOY).eval()
    load_jax_variables(unrolled, unstack_mega_block_params(variables["params"]),
                       unstack_mega_block_params(variables["batch_stats"]))
    for (name, a), (_, b) in zip(tmodel.state_dict().items(), unrolled.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n_model", [2, 4])
def test_stacked_count_that_disagrees_with_the_model_raises(n_model):
    _, variables, _ = _scan_pair()
    model = TorchTitaNet(**{**TOY, "n_mega_blocks": n_model})
    with pytest.raises(ValueError, match="stacks 3 mega-blocks, the model has"):
        load_jax_variables(model, variables["params"], variables["batch_stats"])


def test_train_state_loads_a_scan_backbone():
    from titanet_torch.losses import build_head
    from titanet_tpu.losses import build_head as jax_build_head

    _, variables, ref = _scan_pair(seed=3)
    jhead = jax_build_head("ce", 16, 5)
    hparams = _numpy_tree(jhead.init(jax.random.key(0), jnp.zeros((2, 16)), jnp.zeros((2,), jnp.int32)))
    model, head = TorchTitaNet(**TOY).eval(), build_head("ce", 16, 5, device="cpu")
    load_jax_train_state(model, head, {"backbone": variables["params"], "head": hparams["params"]},
                         variables["batch_stats"])
    for (name, a), (_, b) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), name
