"""Baseline models, port of ``titanet_tpu/models/baselines.py``:

- :class:`DumbConvNet` — stacked ConvBlock1d + linear + mean pool, the
  reference's smoke-test model of the learning loop;
- :class:`DVectorBaseline` — the d-vector recurrent baseline (Wan et al.,
  arXiv:1710.10467): overlapping 160-frame segments -> 3-layer LSTM ->
  mean-or-last hidden state -> linear projection -> mean over segments.
  Every segment of the batch runs through the LSTM as one batch.

The LSTM layers are :class:`LSTMLayer`, one per flax ``OptimizedLSTMCell``
of the JAX model (``lstm_0``, ``lstm_1``, ...): torch's packed gate layout
(rows i, f, g, o) with ONE bias per layer, as the flax cell has (its
hidden-to-hidden kernels carry it), so the parameter count is the JAX
model's. The stack runs as one ``torch.lstm`` call (cuDNN on the card). As
in the JAX model the LSTM runs in f32 whatever the model's dtype (the flax
cells take no compute dtype); only ``projection`` computes in ``dtype``.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
from torch import nn

from titanet_torch.models import common
from titanet_torch.models.titanet import ConvBlock1d
from titanet_torch.ops.dense import Dense

# cuDNN copies separate weight tensors into its own buffer on every call
# and warns about it; the copy is a few MB a call, so the warning is noise
warnings.filterwarnings("ignore", message="RNN module weights are not part of single contiguous chunk")


class DumbConvNet(nn.Module):
    """``[B, T, M] -> [B, E]``: n_layers ConvBlocks, linear, (masked) mean
    over time."""

    def __init__(
        self,
        n_mels: int = 80,
        hidden_size: int = 256,
        embedding_size: int = 192,
        kernel_size: int = 3,
        n_layers: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.embedding_size, self.dtype, self.n_layers = embedding_size, dtype, n_layers
        for i in range(n_layers):
            self.add_module(
                f"conv_{i}", ConvBlock1d(n_mels if i == 0 else hidden_size, hidden_size, kernel_size, dtype=dtype)
            )
        self.fc = Dense(hidden_size, embedding_size, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        common.reset_parameters(self, generator)

    def forward(self, x, mask=None, generator=None):
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x, mask=mask)
        x = self.fc(x)
        if mask is not None:
            m = mask.to(x.dtype)[..., None]
            return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return x.mean(dim=1)


class LSTMLayer(nn.Module):
    """The parameters of one LSTM layer in torch's packed layout:
    ``weight_ih [4H, in]``, ``weight_hh [4H, H]`` and one ``bias [4H]``,
    gate rows i, f, g, o."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias = nn.Parameter(torch.empty(4 * hidden_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch ``nn.LSTM``'s init (the reference's): U(+-1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in (self.weight_ih, self.weight_hh, self.bias):
                p.uniform_(-bound, bound, generator=generator)


def lstm_stack(layers, x: torch.Tensor, training: bool = False) -> torch.Tensor:
    """Run ``layers`` (:class:`LSTMLayer`) over ``x [N, S, in]`` (f32) from
    zero states: the last layer's hidden states ``[N, S, H]``."""
    hidden = layers[0].hidden_size
    flat = []
    for layer in layers:
        flat += [layer.weight_ih, layer.weight_hh, layer.bias, torch.zeros_like(layer.bias)]
    h0 = x.new_zeros(len(layers), x.shape[0], hidden)
    out, _, _ = torch.lstm(x, (h0, h0), flat, True, len(layers), 0.0, training, False, True)
    return out


class DVectorBaseline(nn.Module):
    """``[B, T, M] -> [B, E]``: segment, LSTM, collapse, project, average.

    ``segment_length`` frames with 50% overlap; an input shorter than one
    segment is right-padded. ``mask`` is ignored, as in the reference."""

    def __init__(
        self,
        n_mels: int = 80,
        n_lstm_layers: int = 3,
        hidden_size: int = 768,
        lstm_average: bool = True,
        embedding_size: int = 256,
        segment_length: int = 160,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.embedding_size, self.dtype = embedding_size, dtype
        self.n_lstm_layers, self.lstm_average, self.segment_length = n_lstm_layers, lstm_average, segment_length
        for layer in range(n_lstm_layers):
            self.add_module(f"lstm_{layer}", LSTMLayer(n_mels if layer == 0 else hidden_size, hidden_size))
        self.projection = Dense(hidden_size, embedding_size, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        common.reset_parameters(self, generator)

    def forward(self, x, mask=None, generator=None):
        b, t, m = x.shape
        seg, hop = self.segment_length, self.segment_length // 2
        if t < seg:
            x = torch.nn.functional.pad(x, (0, 0, 0, seg - t))
            t = seg
        # [B, N, M, S] windows -> [B*N, S, M]
        segments = x.unfold(1, seg, hop).transpose(2, 3)
        n_segments = segments.shape[1]
        segments = segments.reshape(b * n_segments, seg, m).float()
        layers = [getattr(self, f"lstm_{i}") for i in range(self.n_lstm_layers)]
        h = lstm_stack(layers, segments, training=self.training)
        outputs = h.mean(dim=1) if self.lstm_average else h[:, -1, :]
        proj = self.projection(outputs)
        return proj.reshape(b, n_segments, self.embedding_size).mean(dim=1)

