"""The port's MFA-Conformer (titanet_torch/models/conformer.py) vs the JAX
package's on the CPU, 2 blocks of dim 32 (4 heads, FF 64, attention hidden
32, embedding 48, dropout 0), from the same weights; the parameter count
at the paper's widths; the relative-position pieces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.models import conformer as tc
from titanet_torch.ops.kernels import dwconv
from titanet_tpu.models import conformer as jc
from torch_zoo_helpers import (
    check_embed_step,
    check_forward,
    check_padded_equals_solo,
    check_param_count,
    check_train_step,
)

SMALL = dict(num_blocks=2, dim=32, num_heads=4, ff_hidden=64, attention_hidden_size=32, embedding_size=48,
             dropout=0.0)


def _torch(dtype=None):
    return tc.get_conformer(dtype=dtype, device="cpu", **SMALL)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(masked):
    check_forward(jc.get_conformer(**SMALL), _torch(), masked)


@pytest.mark.parametrize("bf16", [False, True])
def test_embed_step_matches_jax(bf16):
    check_embed_step(jc.get_conformer(**SMALL), _torch(torch.bfloat16 if bf16 else None), bf16)


@pytest.mark.parametrize("solo_len", [60, 61])  # even and odd valid lengths
def test_masked_padded_equals_solo(solo_len):
    check_padded_equals_solo(_torch(), solo_len)


def test_train_step_matches_jax():
    check_train_step(jc.get_conformer(**SMALL), lambda: tc.MfaConformer(**SMALL))


def test_param_count_at_paper_scale_matches_jax():
    check_param_count(jc.get_conformer(), tc.MfaConformer())


def test_rel_shift_matches_gather():
    """out[i, j] picks the relative distance i - j: x[i, (T-1) - i + j]."""
    t = 7
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, t, 2 * t - 1)).astype(np.float32))
    i, j = torch.arange(t)[:, None], torch.arange(t)[None, :]
    gathered = x[:, :, i, (t - 1) - i + j]
    assert torch.equal(tc.rel_shift(x), gathered)
    np.testing.assert_array_equal(tc.rel_shift(x).numpy(), np.asarray(jc.rel_shift(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("t,dim", [(5, 16), (51, 32)])
def test_rel_pos_embedding_matches_jax(t, dim):
    np.testing.assert_allclose(tc.rel_pos_embedding(t, dim).numpy(), np.asarray(jc.rel_pos_embedding(t, dim)),
                               rtol=1e-6, atol=2e-6)


def test_fully_padded_query_rows_stay_finite():
    """Padded keys take an additive -1e9 in f32, not -inf: an utterance
    whose every frame is masked gives finite attention outputs."""
    att = tc.RelPosSelfAttention(32, 4).eval()
    mask = torch.ones(2, 9)
    mask[1] = 0
    out = att(torch.randn(2, 9, 32), mask=mask)
    assert torch.isfinite(out).all()


def test_depthwise_conv_never_takes_the_kernel_route(monkeypatch):
    """The conv module's depthwise conv is a plain flax nn.Conv in the JAX
    package: under TITANET_DW_BWD=pallas it still runs the library conv,
    even where the kernel would take its shape (bf16, K=15 < 4096 frames,
    C=128)."""
    monkeypatch.setenv("TITANET_DW_BWD", "pallas")
    monkeypatch.setattr(dwconv, "kernel_supports", lambda *a: True)
    monkeypatch.setattr(dwconv, "depthwise_conv1d_fused_bwd",
                        lambda *a: (_ for _ in ()).throw(AssertionError("kernel route taken")))
    module = tc.ConformerConvModule(128, 15, dtype=torch.bfloat16).train()
    out = module(torch.randn(2, 20, 128).bfloat16())
    out.float().sum().backward()
    assert module.dw.weight.grad is not None
