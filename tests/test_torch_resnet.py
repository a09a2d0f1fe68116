"""The port's ResNet r-vector (titanet_torch/models/resnet.py) vs the JAX
package's on the CPU, ResNet18 at base 8 (embedding 48), from the same
weights; parameter counts at the r-vector's widths."""

import pytest
import torch

from titanet_torch.models import resnet as tr
from titanet_tpu.models import resnet as jr
from torch_zoo_helpers import (
    check_embed_step,
    check_forward,
    check_padded_equals_solo,
    check_param_count,
    check_train_step,
)

SMALL = dict(depth=18, base_channels=8, embedding_size=48)


def _torch(dtype=None):
    return tr.get_resnet(dtype=dtype, device="cpu", **SMALL)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(masked):
    """Also holds the layout traps: fixed k//2 padding, not "SAME", and the
    frequency-major flatten before pooling (the embedding's rows)."""
    check_forward(jr.get_resnet(**SMALL), _torch(), masked)


@pytest.mark.parametrize("bf16", [False, True])
def test_embed_step_matches_jax(bf16):
    check_embed_step(jr.get_resnet(**SMALL), _torch(torch.bfloat16 if bf16 else None), bf16)


@pytest.mark.parametrize("solo_len", [60, 61])  # even and odd valid lengths
def test_masked_padded_equals_solo(solo_len):
    check_padded_equals_solo(_torch(), solo_len)


def test_train_step_matches_jax():
    check_train_step(jr.get_resnet(**SMALL), lambda: tr.SpeakerResNet(**SMALL))


@pytest.mark.parametrize("depth", [18, 34])
def test_param_count_at_rvector_scale_matches_jax(depth):
    check_param_count(jr.get_resnet(depth=depth), tr.SpeakerResNet(depth=depth))


def test_unknown_depth_raises():
    with pytest.raises(ValueError, match="depth"):
        tr.SpeakerResNet(depth=50)
