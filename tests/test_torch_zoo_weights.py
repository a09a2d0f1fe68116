"""The weight bridge on the model zoo's leaves (2-D convs, LayerNorm, flax
LSTM cells) and the reference d-vector ``.pth`` converter, port vs the JAX
package's, on the CPU."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.models import baselines as tb
from titanet_torch.models import conformer as tcf
from titanet_torch.models import resnet as tr
from titanet_torch.utils import torch_compat as tc
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.models import baselines as jb
from titanet_tpu.models import conformer as jcf
from titanet_tpu.models import resnet as jr
from titanet_tpu.utils import torch_compat as jc
from torch_zoo_helpers import jax_variables

RESNET = dict(depth=18, base_channels=8, embedding_size=48)
CONFORMER = dict(num_blocks=1, dim=32, num_heads=4, ff_hidden=64, attention_hidden_size=32, embedding_size=48)
DVEC = dict(n_lstm_layers=2, hidden_size=32, embedding_size=48, segment_length=40)

# (family, path of a leaf in the JAX params): a Conv2d kernel, a LayerNorm
# scale, a flax LSTM cell's input and hidden kernels
LEAVES = {
    "conv2d": ("resnet", ("stage2_block1", "conv1", "conv", "kernel")),
    "conv2d_bias": ("conformer", ("subsample", "conv1", "bias")),
    "layernorm": ("conformer", ("block_0", "ln_mhsa", "scale")),
    "lstm_input": ("dvector", ("lstm_0", "ig", "kernel")),
    "lstm_hidden": ("dvector", ("lstm_1", "ho", "bias")),
}


def _pair(family):
    jmodel, tmodel = {
        "resnet": (jr.get_resnet(**RESNET), tr.SpeakerResNet(**RESNET)),
        "conformer": (jcf.get_conformer(**CONFORMER), tcf.MfaConformer(**CONFORMER)),
        "dvector": (jb.DVectorBaseline(**DVEC), tb.DVectorBaseline(**DVEC)),
    }[family]
    return jmodel, copy.deepcopy(jax_variables(jmodel)), tmodel


def _at(tree, path):
    for key in path[:-1]:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_bridge_loads_the_zoo_leaves_and_refuses_a_wrong_shape(leaf):
    family, path = LEAVES[leaf]
    _, v, tmodel = _pair(family)
    load_jax_variables(tmodel, v["params"], v["batch_stats"])  # loads as it is
    node = _at(v["params"], path)
    node[path[-1]] = np.concatenate([node[path[-1]], node[path[-1]][..., :1]], axis=-1)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tmodel, v["params"], v["batch_stats"])


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_bridge_refuses_an_unused_leaf(leaf):
    family, path = LEAVES[leaf]
    _, v, tmodel = _pair(family)
    _at(v["params"], path)["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="do not match"):
        load_jax_variables(tmodel, v["params"], v["batch_stats"])


def _reference_dvector_state_dict(seed, n_layers=3, hidden=32, n_mels=80, emb=48):
    """A state dict in the reference's d-vector layout (``recurrent`` an
    ``nn.LSTM``, ``projection`` a ``Linear``), drawn from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k in range(n_layers):
        width = n_mels if k == 0 else hidden
        for name, shape in ((f"weight_ih_l{k}", (4 * hidden, width)), (f"weight_hh_l{k}", (4 * hidden, hidden)),
                            (f"bias_ih_l{k}", (4 * hidden,)), (f"bias_hh_l{k}", (4 * hidden,))):
            sd[f"recurrent.{name}"] = torch.from_numpy((rng.standard_normal(shape) * 0.15).astype(np.float32))
    sd["projection.weight"] = torch.from_numpy((rng.standard_normal((emb, hidden)) * 0.2).astype(np.float32))
    sd["projection.bias"] = torch.from_numpy((rng.standard_normal(emb) * 0.1).astype(np.float32))
    return sd


@pytest.mark.parametrize("average", [True, False])
def test_reference_dvector_state_dict_embeds_as_jax(average):
    """One reference-layout state dict through the JAX package's converter
    into its model and through the port's into the port's: the forwards
    agree within 1e-5."""
    sd = _reference_dvector_state_dict(7)
    kw = dict(n_lstm_layers=3, hidden_size=32, embedding_size=48, segment_length=40, lstm_average=average)
    jmodel = jb.DVectorBaseline(**kw)
    params = jc.convert_dvector_state_dict(sd)
    model = tb.DVectorBaseline(**kw).eval()
    model.load_state_dict(tc.convert_dvector_state_dict(sd), strict=True)
    x = np.random.default_rng(2).standard_normal((3, 97, 80)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_reference_dvector_converter_refuses_another_state_dict():
    with pytest.raises(KeyError, match="d-vector"):
        tc.convert_dvector_state_dict({"projection.weight": torch.zeros(2, 2)})
