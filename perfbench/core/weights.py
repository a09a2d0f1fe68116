"""Weights and audio made on the device from a seed, in a few large calls.

Weights: one uniform draw of every parameter's elements at once from a
generator on the device, each parameter's slice scaled to its
U(+-1/sqrt(fan_in)) bound; BatchNorm scales 1 and shifts 0, as a fresh
model has them.

Audio: each segment is a voiced sound of its speaker (a fundamental
between 90 and 250 Hz, eight harmonics shaped by the speaker's tilt and
formant, a syllable-rate envelope) plus a little noise, so rows differ
from one another as speech does and BatchNorm's batch statistics are
those of distinct voices, not of one noise."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

HARMONICS = 8
CHUNK = 1 << 25  # samples synthesized at once


def draw_weights(spec: List[Tuple[str, tuple, str, int]], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for ``(name, shape, init, fan_in)``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = sum(math.prod(s) for _, s, init, _ in spec if init == "uniform")
    flat = torch.rand(n, generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, pos = {}, 0
    for name, shape, init, fan_in in spec:
        if init == "uniform":
            size = math.prod(shape)
            out[name] = flat[pos:pos + size].view(shape).mul_(1.0 / math.sqrt(fan_in))
            pos += size
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def synth(lengths: np.ndarray, speaker_of: np.ndarray, n_speakers: int, seed: int, device,
          sample_rate: int = 16000) -> torch.Tensor:
    """The segments of ``lengths`` samples, back to back, as one float32
    tensor on ``device`` in [-1, 1]; segment ``i`` is voiced by speaker
    ``speaker_of[i]``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def rand(n):
        return torch.rand(n, generator=gen, device=device, dtype=torch.float64)

    f0 = 90.0 + 160.0 * rand(n_speakers)
    tilt = 1.0 + 2.0 * rand(n_speakers)
    formant = 300.0 + 2500.0 * rand(n_speakers)
    harm = torch.arange(1, HARMONICS + 1, device=device, dtype=torch.float64)
    amps = torch.exp(-(harm - 1.0) / tilt[:, None]) * (
        1.0 + torch.exp(-((harm * f0[:, None] - formant[:, None]) / 400.0) ** 2))  # [speakers, harmonics]
    nseg = len(lengths)
    phase, rate = rand(nseg), 2.0 + 4.0 * rand(nseg)
    gain = 0.05 + 0.25 * rand(nseg)
    lengths_t = torch.as_tensor(np.asarray(lengths, np.int64), device=device)
    spk = torch.as_tensor(np.asarray(speaker_of, np.int64), device=device)
    starts = torch.cumsum(lengths_t, 0) - lengths_t
    total = int(np.sum(lengths, dtype=np.int64))
    out = torch.empty(total, dtype=torch.float32, device=device)
    ends = np.cumsum(np.asarray(lengths, np.int64))
    a = 0
    while a < nseg:
        # segments [a, b): at least one, at most CHUNK samples unless one is longer
        b = max(a + 1, int(np.searchsorted(ends, (ends[a - 1] if a else 0) + CHUNK, side="right")))
        b = min(b, nseg)
        seg = torch.arange(a, b, device=device)
        idx = torch.repeat_interleave(seg, lengths_t[a:b])
        base = int(ends[a - 1]) if a else 0
        n = idx.numel()
        t = (torch.arange(n, device=device, dtype=torch.float64) + base - starts[idx]) / sample_rate
        s = spk[idx]
        cycles = f0[s] * t + phase[idx]
        y = torch.zeros(n, dtype=torch.float64, device=device)
        for h in range(HARMONICS):
            y += amps[s, h] * torch.sin(2.0 * math.pi * torch.frac((h + 1) * cycles))
        env = 0.55 + 0.45 * torch.sin(2.0 * math.pi * (rate[idx] * t + phase[idx]))
        y = y * env * gain[idx] / 2.0
        y += 0.01 * torch.randn(n, generator=gen, device=device, dtype=torch.float64)
        out[base:base + n] = y.clamp_(-1.0, 1.0).float()
        a = b
    return out
