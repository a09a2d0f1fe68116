"""Model export (port of ``titanet_tpu/utils/export.py``).

The embedding extractor is exported ahead of time with ``torch.export``
(in place of ``jax.export``): the artifact is the bytes of
``torch.export.save``, weights included; it loads without the
model-building code and runs on the device it was exported on.

Kernel routing follows the frontend config, as in the JAX package. The
default (``use_pallas_fused=False``) exports the plain torch frontend.
With ``use_pallas_fused=True`` the graph holds the hand-written fused
log-mel kernel as the operator ``torch.ops.titanet_torch.log_mel_fused``
(:func:`titanet_torch.ops.kernels.melspec.log_mel_fused_op`): loading such
an artifact needs ``titanet_torch.ops.kernels`` imported, which
:func:`load_embedder` does. A model whose forward would reach another
kernel through its ctypes wrapper (the bf16 attentive-pool kernel on the
card) cannot be traced, and export raises rather than record the plain
route.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def export_embedder(
    fn: Callable,
    example_args: Sequence,
    path: Optional[str] = None,
) -> bytes:
    """Export ``fn`` (an ``nn.Module``, or a callable wrapped into one) at
    the shapes of ``example_args``; returns the ``torch.export.save`` bytes,
    also written to ``path`` when given."""
    module = fn if isinstance(fn, nn.Module) else _Wrapped(fn)
    program = torch.export.export(module, tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_embedder(path_or_bytes) -> Callable:
    """Load an exported artifact (a path or the bytes); returns a callable
    module (frozen weights)."""
    import titanet_torch.ops.kernels  # noqa: F401  (registers the fused log-mel operator)

    blob = path_or_bytes
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    module = torch.export.load(io.BytesIO(blob)).module()
    for p in module.parameters():
        p.requires_grad_(False)  # an inference artifact: no autograd graph
    return module


class _Wrapped(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Embedder(nn.Module):
    """wav ``[B, T]`` f32, lengths ``[B]`` int32 -> log-mel -> model -> l2
    normalize, the same chain as the JAX package's exported embedder."""

    def __init__(self, model: nn.Module, frontend):
        super().__init__()
        self.model, self.frontend = model, frontend

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        from titanet_torch.models import l2_normalize
        from titanet_torch.ops.frontend import log_mel_fused_operands, log_mel_spectrogram

        if self.frontend.use_pallas_fused:
            args, kw = log_mel_fused_operands(wav, self.frontend, lengths)
            mel = torch.ops.titanet_torch.log_mel_fused(*args, **kw)
        else:
            mel, _ = log_mel_spectrogram(wav, self.frontend, lengths=lengths)
        return l2_normalize(self.model(mel))


def _refuse_untraceable_kernels(model: nn.Module, device: torch.device) -> None:
    """The attentive-pool kernel is reached through ctypes in a bf16 model
    on the card; a traced graph cannot hold it."""
    from titanet_torch.ops.pooling import AttentiveStatsPooling

    bf16_pools = [m for m in model.modules()
                  if isinstance(m, AttentiveStatsPooling) and m.dtype == torch.bfloat16]
    if device.type == "cuda" and bf16_pools:
        raise NotImplementedError(
            "exporting a bf16 model with attentive pooling on the card needs the pool kernel "
            "registered as an operator (ROADMAP Queue 1 item 11); export it in f32"
        )


def export_titanet_embedder(
    model: nn.Module,
    variables=None,
    frontend=None,
    batch_size: int = 8,
    num_samples: int = 48000,
    path: Optional[str] = None,
) -> bytes:
    """Export the whole wav -> embedding pipeline with the weights in the
    artifact. ``variables`` is None (the model's own weights), a
    :class:`~titanet_torch.train.state.TrainState` (its eval weights: the
    EMA copy when the run kept one) or a ``state_dict`` loaded into the
    model. The example inputs are ``[batch_size, num_samples]`` zeros on the
    model's device; the artifact takes exactly that shape."""
    from titanet_torch.ops.frontend import FrontendConfig

    if variables is not None:
        if hasattr(variables, "model"):
            from titanet_torch.train.state import ema_eval_state

            model = ema_eval_state(variables).model
        else:
            model.load_state_dict(variables)
    frontend = frontend or FrontendConfig()
    device = next(model.parameters()).device
    _refuse_untraceable_kernels(model, device)
    model.eval()
    example = (
        torch.zeros(batch_size, num_samples, dtype=torch.float32, device=device),
        torch.full((batch_size,), num_samples, dtype=torch.int32, device=device),
    )
    embedder = _Embedder(model, frontend).eval()
    with torch.no_grad():
        embedder(*example)  # builds the frontend's constants outside the trace
        return export_embedder(embedder, example, path=path)
