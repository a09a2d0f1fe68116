"""On-device audio augmentations (port of ``titanet_tpu/ops/augment.py``).

Batched rebuilds of the reference's per-example transforms
(``src/transforms.py``), as in the JAX package:

- SpecAugment frequency/time masking (torchaudio ``mask_along_axis``
  semantics), and the full training frontend with the per-example gated
  time stretch (:func:`log_mel_specaugment`);
- the phase vocoder (torchaudio ``phase_vocoder``);
- sinc-interpolation resampling (torchaudio ``functional.resample``:
  hann-windowed sinc, lowpass_filter_width 6, rolloff 0.99) and speed
  perturbation built on it;
- convolution reverb through the FFT;
- additive white or pink noise at a random SNR.

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device, never from the global generator; under an active mesh every
draw is made over the global batch and each rank keeps its rows
(:func:`titanet_torch.parallel.mesh.draw_rows`). The draws are not the JAX
package's (a ``jax.random`` key cannot be replayed in torch), so the random
functions match the JAX ones in distribution; every deterministic piece
(the stretch matrix, the sinc kernel, a mask at given uniforms, the
stretch at a fixed rate) matches it in value.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from titanet_torch.parallel.mesh import draw_rows


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    return draw_rows(lambda s: torch.rand(s, generator=generator, device=device, dtype=torch.float32), shape)


@contextlib.contextmanager
def _tf32_off():
    """f32 products on the card, as ``Precision.HIGHEST`` asks on the TPU."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# SpecAugment masking
# ---------------------------------------------------------------------------


def mask_from_uniforms(
    spec: torch.Tensor,
    u_width: torch.Tensor,
    u_start: torch.Tensor,
    mask_param,
    axis: int,
    mask_value: float = 0.0,
    size=None,
) -> torch.Tensor:
    """The deterministic half of :func:`mask_along_axis`: per row ``r`` of
    ``spec [B, ...]``, ``width = u_width[r] * mask_param``, ``start =
    u_start[r] * (size - width)``, and ``[int(start), int(start + width))``
    along ``axis`` (an axis of ``spec``, not 0) is set to ``mask_value``.
    ``mask_param`` and ``size`` are scalars or ``[B]`` tensors."""
    dim = spec.shape[axis]
    if size is None:
        size = dim
    value = u_width * mask_param
    min_value = u_start * (size - value)
    start = min_value.to(torch.int32)
    end = (min_value + value).to(torch.int32)
    ids = torch.arange(dim, device=spec.device)
    mask = (ids[None, :] >= start[:, None]) & (ids[None, :] < end[:, None])
    shape = [spec.shape[0]] + [1] * (spec.dim() - 1)
    shape[axis] = dim
    return torch.where(mask.reshape(shape), mask_value, spec)


def mask_along_axis(
    generator: torch.Generator,
    spec: torch.Tensor,
    mask_param,
    axis: int,
    mask_value: float = 0.0,
    size=None,
) -> torch.Tensor:
    """torchaudio ``mask_along_axis`` semantics for each row of ``spec [B,
    ...]``: ``width ~ U(0, mask_param)``, ``start ~ U(0, size - width)``,
    zero out ``[int(start), int(start + width))`` along ``axis``.

    ``mask_param`` and ``size`` may be ``[B]`` tensors: with per-row valid
    frame counts the mask is drawn over each row's TRUE extent, as the
    reference masks each example before collation."""
    u = _uniform(generator, (spec.shape[0], 2), spec.device)
    return mask_from_uniforms(spec, u[:, 0], u[:, 1], mask_param, axis, mask_value, size)


def spec_augment(
    generator: torch.Generator,
    spec: torch.Tensor,
    freq_mask_ratio: float = 0.35,
    freq_mask_num: int = 1,
    time_mask_ratio: float = 0.15,
    time_mask_num: int = 1,
    probability: float = 1.0,
    frames_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched SpecAugment masking on ``[B, F, M]`` log-mel spectrograms.

    Mask widths are ``ratio * dim_size`` (reference src/transforms.py:
    188-201); the augment is gated per example with ``probability``; the
    time-mask width scales with the padded frame count."""
    b, n_frames, n_mels = spec.shape
    gate = _uniform(generator, (b,), spec.device) < probability
    out = spec
    for _ in range(freq_mask_num):
        out = mask_along_axis(generator, out, freq_mask_ratio * n_mels, axis=2)
    for _ in range(time_mask_num):
        out = mask_along_axis(generator, out, time_mask_ratio * n_frames, axis=1)
    out = torch.where(gate[:, None, None], out, spec)
    if frames_mask is not None:
        out = out * frames_mask[..., None]
    return out


# ---------------------------------------------------------------------------
# Phase vocoder (time stretch)
# ---------------------------------------------------------------------------


def phase_vocoder(spec: torch.Tensor, rate: float, hop_length: int, n_fft: int) -> torch.Tensor:
    """torchaudio ``phase_vocoder``: stretch a complex spectrogram
    ``[..., freq, time]`` by ``rate`` (a Python float; the output has
    ``ceil(time / rate)`` frames)."""
    if rate == 1.0:
        return spec
    n_freq, n_time = spec.shape[-2], spec.shape[-1]
    real = torch.float64 if spec.dtype == torch.complex128 else torch.float32
    phi_advance = torch.linspace(0, math.pi * hop_length, n_freq, dtype=real, device=spec.device)[..., None]
    time_steps = torch.arange(0, n_time, rate, dtype=real, device=spec.device)
    alphas = time_steps % 1.0
    spec_pad = F.pad(spec, (0, 2))
    idx = time_steps.to(torch.long)
    spec_0 = spec_pad[..., idx]
    spec_1 = spec_pad[..., idx + 1]
    angle_0, angle_1 = torch.angle(spec_0), torch.angle(spec_1)
    norm_0, norm_1 = torch.abs(spec_0), torch.abs(spec_1)
    phase = angle_1 - angle_0 - phi_advance
    phase = phase - 2.0 * math.pi * torch.round(phase / (2.0 * math.pi))
    phase = phase + phi_advance
    # accumulate, starting from the first frame's phase
    phase = torch.cat([angle_0[..., :1], phase[..., :-1]], dim=-1)
    phase_acc = torch.cumsum(phase, dim=-1)
    mag = alphas * norm_1 + (1.0 - alphas) * norm_0
    return torch.polar(mag, phase_acc)


class AugmentConfig(NamedTuple):
    """SpecAugment and noise hyper-parameters of the train step (the JAX
    package's ``AugmentConfig``, field for field)."""

    min_rate: float = 0.95
    max_rate: float = 1.05
    freq_mask_ratio: float = 0.35
    freq_mask_num: int = 1
    time_mask_ratio: float = 0.15
    time_mask_num: int = 1
    probability: float = 1.0
    time_stretch: bool = True
    # False = skip the stretch+masking path entirely (noise-only configs)
    specaugment: bool = True
    # additive noise at a random SNR; 0.0 = off
    noise_prob: float = 0.0
    noise_snr_min: float = 5.0  # dB
    noise_snr_max: float = 20.0  # dB
    noise_color: str = "white"  # "white" | "pink"


def stretch_interp_matrix(n_time: int, rate, dtype=torch.float32, device=None) -> torch.Tensor:
    """``[..., n_time, n_time + 2]`` banded linear-interpolation matrix ``W``
    such that ``W @ S_pad`` equals torchaudio ``phase_vocoder``'s magnitude
    path at a FIXED output length: row ``j`` holds ``1 - alpha_j`` at column
    ``idx_j = floor(j * rate)`` and ``alpha_j = j*rate % 1`` at
    ``idx_j + 1`` (``S_pad`` carries two trailing zero frames). ``rate`` is
    a scalar or a ``[B]`` tensor (one matrix per row); rows past
    ``ceil(valid / rate)`` read the zero pad and are masked by the caller."""
    rate = torch.as_tensor(rate, dtype=dtype, device=device)
    steps = torch.arange(n_time, dtype=dtype, device=rate.device) * rate[..., None]
    alphas = steps % 1.0
    idx = torch.clamp(steps.to(torch.int32), max=n_time)  # clamp into zero pad
    cols = torch.arange(n_time + 2, device=rate.device)
    w0 = (cols == idx[..., None]) * (1.0 - alphas)[..., None]
    w1 = (cols == (idx + 1)[..., None]) * alphas[..., None]
    return (w0 + w1).to(dtype)


def log_mel_specaugment(
    generator: torch.Generator,
    waveform: torch.Tensor,
    frontend_cfg,
    aug: AugmentConfig,
    lengths: Optional[torch.Tensor] = None,
    mel_fb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training frontend with SpecAugment: ``[B, T] -> ([B, F, n_mels],
    frames_mask [B, F])``, as the JAX function computes it.

    ONE per-example gate ``u < probability`` turns on both the time stretch
    (rate ~ U(min_rate, max_rate)) and the frequency/time masking. The
    stretch interpolates frame magnitudes, ``alpha*|s1| + (1-alpha)*|s0|``
    (the reference squares the stretched magnitude at once, so the
    vocoder's phase cancels), as one banded product per example in f32
    with TF32 off. Time masks are drawn over each row's post-stretch valid
    frame count, and the output is zeroed past it. The mel product runs
    in plain torch, never in the fused log-mel kernel: that kernel has no
    place for the stretch between the power and the mel product.
    """
    from titanet_torch.ops.frontend import _constants, amplitude_to_db, l2_normalize_mels, spectrogram

    cfg = frontend_cfg
    if mel_fb is None:
        mel_fb = _constants(cfg, waveform.device, torch.float32)[4]
    if lengths is not None:
        lengths = lengths.to(waveform.device)
    p = spectrogram(waveform.to(torch.float32), cfg, power=2.0, lengths=lengths)  # [B, F, bins]
    b, n_frames, _ = p.shape
    dev = p.device
    if lengths is not None:
        valid = (1 + lengths.to(torch.long) // cfg.hop_length).to(torch.int32)
    else:
        valid = torch.full((b,), n_frames, dtype=torch.int32, device=dev)
    frame_ids = torch.arange(n_frames, device=dev)
    u = _uniform(generator, (b, 2), dev)
    gate = u[:, 0] < aug.probability
    drawn = torch.clamp(u[:, 1] * (aug.max_rate - aug.min_rate) + aug.min_rate, min=aug.min_rate)
    rate = torch.where(gate, drawn, torch.ones_like(drawn))
    if aug.time_stretch:
        # reference .abs() then stretch: interpolate amplitudes, square
        amp = torch.sqrt(p) * (frame_ids[None, :] < valid[:, None])[..., None].to(p.dtype)
        w = stretch_interp_matrix(n_frames, rate, p.dtype)
        with _tf32_off():
            amp = torch.bmm(w, F.pad(amp, (0, 0, 0, 2)))
        p = amp * amp
        new_valid = torch.clamp(torch.ceil(valid.to(torch.float32) / rate).to(torch.int32), max=n_frames)
    else:
        new_valid = valid
    out = l2_normalize_mels(amplitude_to_db(p @ mel_fb.to(p.dtype)))  # [B, F, n_mels]
    n_mels = out.shape[-1]
    masked = out
    for _ in range(aug.freq_mask_num):
        masked = mask_along_axis(generator, masked, aug.freq_mask_ratio * n_mels, axis=2)
    time_param = aug.time_mask_ratio * new_valid
    for _ in range(aug.time_mask_num):
        masked = mask_along_axis(generator, masked, time_param, axis=1, size=new_valid)
    out = torch.where(gate[:, None, None], masked, out)
    mask = (frame_ids[None, :] < new_valid[:, None]).to(out.dtype)
    return out * mask[..., None], mask


# ---------------------------------------------------------------------------
# Resampling (sinc interpolation) and speed perturbation
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> Tuple[np.ndarray, int]:
    """torchaudio ``_get_sinc_resample_kernel`` (sinc_interp_hann):
    returns (kernels [new_freq_g, 1, K] float32 numpy, width)."""
    gcd = math.gcd(orig_freq, new_freq)
    orig_freq, new_freq = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, None] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t *= math.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width


def resample(
    waveform: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """torchaudio ``functional.resample`` for ``[B, T]`` waveforms: one
    strided f32 convolution per polyphase branch, outputs interleaved."""
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(orig_freq, new_freq)
    of, nf = orig_freq // gcd, new_freq // gcd
    kernels, width = _sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    length = waveform.shape[-1]
    x = F.pad(waveform.to(torch.float32), (width, width + of))
    k = torch.from_numpy(kernels).to(x.device)
    out = F.conv1d(x[:, None, :], k, stride=of)  # [B, nf, T // of]
    out = out.transpose(1, 2).reshape(out.shape[0], -1)  # interleave polyphase outputs
    target_length = int(math.ceil(nf * length / of))
    return out[..., :target_length]


def speed_perturb(waveform: torch.Tensor, sample_rate: int, speed: float) -> Tuple[torch.Tensor, int]:
    """Speed change by resampling (sox ``speed`` + ``rate``): the output has
    ``round(T / speed)`` samples at the same sample rate."""
    new_freq = int(round(sample_rate / speed))
    out = resample(waveform, sample_rate, new_freq)
    return out, out.shape[-1]


# ---------------------------------------------------------------------------
# Convolution reverb
# ---------------------------------------------------------------------------


def reverb(waveform: torch.Tensor, rir: torch.Tensor, normalize_rir: bool = True) -> torch.Tensor:
    """Convolve ``[B, T]`` waveforms with a room impulse response ``[L]``
    (reference src/transforms.py:270-298): the RIR power-normalized, the
    causal convolution truncated to ``T``, through the FFT."""
    if normalize_rir:
        rir = rir / torch.linalg.vector_norm(rir)
    t, l = waveform.shape[-1], rir.shape[-1]
    n = 1
    while n < t + l - 1:
        n *= 2
    full = torch.fft.irfft(torch.fft.rfft(waveform, n=n) * torch.fft.rfft(rir, n=n), n=n)
    return full[..., :t].to(waveform.dtype)


# ---------------------------------------------------------------------------
# Additive noise
# ---------------------------------------------------------------------------


def add_noise(
    generator: torch.Generator,
    waveform: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    probability: float = 1.0,
    snr_min: float = 5.0,
    snr_max: float = 20.0,
    color: str = "white",
) -> torch.Tensor:
    """Per-example gated additive noise at ``SNR ~ U(snr_min, snr_max)`` dB:
    ``white`` Gaussian or ``pink`` (1/f power, shaped with one batched
    rFFT). The noise power is matched to each example's power over its
    VALID samples, and padded samples stay exactly zero."""
    b, t = waveform.shape
    dev = waveform.device
    wf = waveform.to(torch.float32)
    u = _uniform(generator, (b, 2), dev)
    gate = u[:, 0] < probability
    snr_db = u[:, 1] * (snr_max - snr_min) + snr_min
    noise = draw_rows(lambda s: torch.randn(s, generator=generator, device=dev, dtype=torch.float32), (b, t))
    if color == "pink":
        freqs = torch.fft.rfftfreq(t, device=dev)
        shape = torch.where(freqs > 0, 1.0 / torch.sqrt(torch.clamp(freqs, min=1e-12)), torch.zeros_like(freqs))
        noise = torch.fft.irfft(torch.fft.rfft(noise, dim=-1) * shape, n=t, dim=-1)
    elif color != "white":
        raise ValueError(f"unknown noise color {color!r}")
    if lengths is not None:
        lengths = lengths.to(dev)
        valid = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).to(torch.float32)
        n = torch.clamp(lengths.to(torch.float32), min=1.0)
    else:
        valid = torch.ones((b, t), dtype=torch.float32, device=dev)
        n = torch.full((b,), float(t), dtype=torch.float32, device=dev)
    sig_pow = torch.sum(wf * wf * valid, dim=-1) / n
    noise_pow = torch.sum(noise * noise * valid, dim=-1) / n
    target = sig_pow / torch.pow(10.0, snr_db / 10.0)
    gain = torch.sqrt(target / torch.clamp(noise_pow, min=1e-12))
    gain = torch.where(gate, gain, torch.zeros_like(gain))
    out = wf + noise * gain[:, None] * valid
    return out.to(waveform.dtype)
