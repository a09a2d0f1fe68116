"""The port's x-vector (titanet_torch/models/xvector.py) vs the JAX
package's on the CPU, at H=32, P=64 (embedding 48), from the same weights;
parameter count at the paper's widths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.models import xvector as tx
from titanet_tpu.models import xvector as jx
from torch_zoo_helpers import (
    check_embed_step,
    check_forward,
    check_padded_equals_solo,
    check_param_count,
    check_train_step,
    mel_batch,
)

SMALL = dict(hidden_size=32, frame_out=64, embedding_size=48)


def _torch(dtype=None):
    return tx.get_xvector(dtype=dtype, device="cpu", **SMALL)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(masked):
    check_forward(jx.get_xvector(**SMALL), _torch(), masked)


@pytest.mark.parametrize("bf16", [False, True])
def test_embed_step_matches_jax(bf16):
    check_embed_step(jx.get_xvector(**SMALL), _torch(torch.bfloat16 if bf16 else None), bf16)


def test_masked_padded_equals_solo():
    check_padded_equals_solo(_torch(), 60)


def test_train_step_matches_jax():
    check_train_step(jx.get_xvector(**SMALL), lambda: tx.XVector(**SMALL))


def test_param_count_at_paper_scale_matches_jax():
    check_param_count(jx.get_xvector(), tx.XVector())


@pytest.mark.parametrize("masked", [False, True])
def test_stats_pool_matches_jax(masked):
    x, mask = mel_batch(3)
    m_j, m_t = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    ref = np.asarray(jx.stats_pool(jnp.asarray(x), mask=m_j))
    got = tx.stats_pool(torch.from_numpy(x), mask=m_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
