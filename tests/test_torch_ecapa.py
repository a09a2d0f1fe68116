"""The port's ECAPA-TDNN (titanet_torch/models/ecapa.py) vs the JAX
package's on the CPU, at C=64 (attention hidden 32, embedding 48), from
the same weights; parameter counts at the paper's widths."""

import pytest
import torch

from titanet_torch.models import ecapa as te
from titanet_tpu.models import ecapa as je
from torch_zoo_helpers import (
    check_embed_step,
    check_forward,
    check_padded_equals_solo,
    check_param_count,
    check_train_step,
)

SMALL = dict(channels=64, attention_hidden_size=32, embedding_size=48)


def _jax(dtype=None):
    return je.get_ecapa(dtype=dtype, **SMALL)


def _torch(dtype=None):
    return te.get_ecapa(dtype=dtype, device="cpu", **SMALL)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(masked):
    check_forward(_jax(), _torch(), masked)


@pytest.mark.parametrize("bf16", [False, True])
def test_embed_step_matches_jax(bf16):
    check_embed_step(_jax(), _torch(torch.bfloat16 if bf16 else None), bf16)


def test_masked_padded_equals_solo():
    check_padded_equals_solo(_torch(), 60)


def test_train_step_matches_jax():
    check_train_step(_jax(), lambda: te.EcapaTdnn(**SMALL))


@pytest.mark.parametrize("channels", [512, 1024])
def test_param_count_at_paper_scale_matches_jax(channels):
    check_param_count(je.get_ecapa(channels=channels), te.EcapaTdnn(channels=channels))


def test_res2_carry_is_zeroed_at_padded_frames():
    """Each conv's bias makes the carry nonzero at padded frames; zeroed
    there, the next conv reads what the solo forward's zero padding gives:
    the padded module's valid frames equal the solo module's."""
    conv = te.Res2DilatedConv(16, 3, 2, scale=4).eval()
    torch.nn.init.uniform_(conv.conv_1.bias, 1.0, 2.0)
    x = torch.randn(1, 20, 16)
    mask = (torch.arange(20) < 12).float()[None]
    padded = conv(x * mask[..., None], mask=mask)
    solo = conv(x[:, :12])
    torch.testing.assert_close(padded[:, :12], solo, rtol=1e-6, atol=1e-6)
    unmasked = conv(x * mask[..., None])
    assert (unmasked[:, :12] - solo).abs().max() > 1e-3  # without the mask the carry leaks
