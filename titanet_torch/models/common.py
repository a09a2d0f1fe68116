"""Construction helpers shared by the model zoo: every parameter drawn in
module order from one generator, and the constructors' common tail
(weights from ``generator``, eval mode, on ``device``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from titanet_torch._device import resolve_device


def reset_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every parameter of ``model`` in module order from
    ``generator``: each module that holds parameters of its own re-draws
    them with its ``reset_parameters(generator)``."""
    for m in model.modules():
        if m._parameters and m is not model:
            m.reset_parameters(generator)


def set_axis_name(model: nn.Module, axis_name: Optional[str]) -> None:
    """Give every BatchNorm of ``model`` the mesh axis of the ``shard_map``
    statistics rule (``titanet_torch.ops.norm``; None: the global-batch
    rule). The zoo constructors' ``axis_name`` lands here."""
    from titanet_torch.ops.norm import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.axis_name = axis_name


def finish(model: nn.Module, device="cuda", generator: Optional[torch.Generator] = None) -> nn.Module:
    """``model`` with weights drawn from ``generator`` (default: a generator
    seeded with 0), in eval mode on ``device``."""
    dev = resolve_device(device)
    reset_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.to(dev).eval()
