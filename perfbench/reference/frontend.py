"""Plain log-mel frontend: waveform -> [frames, n_mels], in float32.

torchaudio's defaults, which the measured program states: center reflect
padding at the utterance's true edges, frames of ``n_fft`` samples every
``hop`` samples, a periodic Hann window of ``win_length`` samples centred in
``n_fft``, a real FFT, the power spectrum, an HTK mel filterbank without
normalization, ``10 * log10(max(power, 1e-10))`` and an L2 normalization
over the mels. Frames at or after ``1 + length // hop`` are zero and masked.
It computes in float64 and gives float32: the configuration states a
float32 log-mel, and this is it to float32's last digit.

Plain torch and numpy only: nothing of the measured program is imported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def hann_padded(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic Hann window of ``win_length`` centred in ``n_fft`` zeros."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    out = np.zeros(n_fft, np.float64)
    left = (n_fft - win_length) // 2
    out[left:left + win_length] = w
    return out


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """Triangular HTK filterbank ``[n_freqs, n_mels]`` from 0 Hz to Nyquist."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    f_pts = to_hz(np.linspace(to_mel(0.0), to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def log_mel(wav: torch.Tensor, fe: dict, lengths: Optional[torch.Tensor] = None,
            n_frames: Optional[int] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``wav [B, T]`` (float) -> ``(mel [B, F, n_mels] f32, mask [B, F] or
    None)``. Without ``lengths`` every row is ``T`` samples long and ``F = 1
    + T // hop``. With ``lengths`` each row is cut at its length, reflected
    there, and computed over ``n_frames`` frames (default ``1 + T // hop``),
    the ones at or after ``1 + length // hop`` zero."""
    n_fft, hop, win = fe["n_fft"], fe["hop_length"], fe["win_length"]
    pad = n_fft // 2
    dev = wav.device
    x = wav.float().double()
    b, t = x.shape
    f_total = n_frames if n_frames is not None else 1 + t // hop
    window = torch.tensor(hann_padded(n_fft, win), dtype=torch.float64, device=dev)
    fb = torch.tensor(mel_filterbank(n_fft // 2 + 1, fe["n_mels"], fe["sample_rate"]),
                      dtype=torch.float64, device=dev)
    out = torch.zeros(b, f_total, fe["n_mels"], dtype=torch.float32, device=dev)
    mask = None if lengths is None else torch.zeros(b, f_total, dtype=torch.float32, device=dev)
    for i in range(b):
        n = t if lengths is None else int(lengths[i])
        f_valid = min(1 + n // hop, f_total)
        if mask is not None:
            mask[i, :f_valid] = 1.0
        if n <= pad:  # a filler row: its frames are never read, they stay zero
            continue
        row = x[i, :n]
        padded = torch.cat([row[1:pad + 1].flip(0), row, row[n - pad - 1:n - 1].flip(0)])
        frames = padded.unfold(0, n_fft, hop)[:f_valid]
        spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        db = 10.0 * torch.log10(torch.clamp(power @ fb, min=1e-10))
        norm = torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-12)
        out[i, :f_valid] = (db / norm).float()
    return out, mask
