"""The port's baselines (titanet_torch/models/baselines.py), DumbConvNet
(2 layers of 32) and the d-vector LSTM (2 layers of 32, segments of 40
frames, embedding 48), vs the JAX package's on the CPU from the same
weights; parameter counts at the configs' widths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.models import baselines as tb
from titanet_tpu.models import baselines as jb
from torch_zoo_helpers import (
    check_embed_step,
    check_forward,
    check_padded_equals_solo,
    check_param_count,
    check_train_step,
    jax_variables,
    load,
)

DUMB = dict(hidden_size=32, embedding_size=48, n_layers=2)
DVEC = dict(n_lstm_layers=2, hidden_size=32, embedding_size=48, segment_length=40)
FAMILIES = {
    "dumb": (lambda: jb.DumbConvNet(**DUMB), lambda dtype=None: tb.DumbConvNet(dtype=dtype, **DUMB)),
    "dvector": (lambda: jb.DVectorBaseline(**DVEC), lambda dtype=None: tb.DVectorBaseline(dtype=dtype, **DVEC)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(family, masked):
    """The d-vector ignores the mask, as the reference does; the convnet
    pools over the valid frames."""
    make_j, make_t = FAMILIES[family]
    check_forward(make_j(), make_t().eval(), masked)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("bf16", [False, True])
def test_embed_step_matches_jax(family, bf16):
    """bf16: only the d-vector's projection computes in bf16; its LSTM runs
    in f32, as the JAX model's flax cells do."""
    make_j, make_t = FAMILIES[family]
    check_embed_step(make_j(), make_t(torch.bfloat16 if bf16 else None).eval(), bf16)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_jax(family):
    make_j, make_t = FAMILIES[family]
    check_train_step(make_j(), make_t)


@pytest.mark.parametrize("family,widths", [("dumb", dict(n_layers=10, hidden_size=256)),
                                           ("dvector", dict(n_lstm_layers=3, hidden_size=768))])
def test_param_count_at_config_scale_matches_jax(family, widths):
    cls = {"dumb": "DumbConvNet", "dvector": "DVectorBaseline"}[family]
    check_param_count(getattr(jb, cls)(embedding_size=192, **widths), getattr(tb, cls)(embedding_size=192, **widths))


@pytest.mark.parametrize("t", [25, 40, 83])  # shorter than a segment (right-padded), one, three
def test_dvector_segments_match_jax(t):
    jm = jb.DVectorBaseline(**DVEC)
    v = jax_variables(jm)
    tm = load(tb.DVectorBaseline(**DVEC), v)
    x = np.random.default_rng(t).standard_normal((2, t, 80)).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_dvector_last_output_matches_jax():
    kw = dict(DVEC, lstm_average=False)
    check_forward(jb.DVectorBaseline(**kw), tb.DVectorBaseline(**kw).eval(), masked=False)


def test_dvector_lstm_runs_in_f32_in_a_bf16_model():
    model = tb.DVectorBaseline(dtype=torch.bfloat16, **DVEC).eval()
    seen = []
    real = torch.lstm
    try:
        torch.lstm = lambda x, *a: seen.append(x.dtype) or real(x, *a)
        out = model(torch.randn(2, 83, 80).bfloat16())
    finally:
        torch.lstm = real
    assert seen == [torch.float32] and out.dtype == torch.bfloat16


def test_dumb_one_layer_masked_padded_equals_solo():
    """One conv layer reads the zero padding the solo forward has: the
    masked mean then gives the solo embedding. (Deeper stacks read
    activations at padded frames, in both packages.)"""
    check_padded_equals_solo(tb.DumbConvNet(hidden_size=32, embedding_size=48, n_layers=1).eval(), 60)


def test_lstm_stack_matches_a_torch_lstm():
    """``lstm_stack`` from one bias a layer equals ``nn.LSTM`` holding that
    bias split across its two."""
    layers = [tb.LSTMLayer(80, 32), tb.LSTMLayer(32, 32)]
    ref = torch.nn.LSTM(80, 32, num_layers=2, batch_first=True)
    with torch.no_grad():
        for k, layer in enumerate(layers):
            getattr(ref, f"weight_ih_l{k}").copy_(layer.weight_ih)
            getattr(ref, f"weight_hh_l{k}").copy_(layer.weight_hh)
            getattr(ref, f"bias_ih_l{k}").copy_(layer.bias * 0.25)
            getattr(ref, f"bias_hh_l{k}").copy_(layer.bias * 0.75)
    x = torch.randn(3, 17, 80)
    with torch.no_grad():
        torch.testing.assert_close(tb.lstm_stack(layers, x), ref(x)[0], rtol=1e-5, atol=1e-6)
