"""Audio frontend: waveform -> log-mel spectrogram (port of
``titanet_tpu/ops/frontend.py``).

The chain matches torchaudio's defaults as the JAX package does:

  center-reflect pad -> frame -> periodic Hann window -> real DFT (as a
  matmul) -> |.|^2 -> HTK mel filterbank -> 10*log10(max(., 1e-10))
  -> L2 over mels

``lengths`` reflects each utterance at its TRUE right edge, so a padded
batch gives the same frames as each utterance alone; frames at or after
``1 + length // hop`` are zeroed and reported in the frame mask.

``FrontendConfig.use_pallas_fused`` routes to the fused CUDA kernel
(:mod:`titanet_torch.ops.kernels.melspec`); plain torch builds the
reflect-padded buffer and the kernel does everything after it. On CPU
tensors that wrapper runs its plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """torch.hann_window(periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return w.astype(dtype)


def padded_window(n_fft: int, win_length: int, dtype=np.float32) -> np.ndarray:
    """Window zero-padded symmetrically to n_fft (torch.stft semantics)."""
    w = hann_window(win_length, dtype)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype)
    out[left : left + win_length] = w
    return out


def hz_to_mel(f):
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank ``[n_freqs, n_mels]`` (torchaudio
    ``melscale_fbanks`` semantics: HTK scale, no normalization)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs, dtype=np.float64)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(dtype)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases ``[n_fft, n_fft//2+1]`` for DFT-as-matmul."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


class FrontendConfig(NamedTuple):
    """Static frontend hyper-parameters (sr 16000, n_fft 512, win 25 ms,
    hop 10 ms, 80 mels)."""

    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400  # samples (25 ms @ 16 kHz)
    hop_length: int = 160  # samples (10 ms @ 16 kHz)
    n_mels: int = 80
    # 'highest': f32 operands everywhere (torchaudio parity).
    # 'default': the fused kernel takes bf16 operands with f32
    # accumulation (serving; ~5e-2 mel error class). The plain path always
    # computes in f32.
    precision: str = "highest"
    # Route log_mel_spectrogram through the fused kernel
    # (ops/kernels/melspec.py): DFT, power, mel, dB and L2 in one launch.
    use_pallas_fused: bool = False

    @classmethod
    def from_ms(cls, sample_rate=16000, n_fft=512, win_ms=25, hop_ms=10, n_mels=80, **kw):
        return cls(
            sample_rate=sample_rate,
            n_fft=n_fft,
            win_length=int(win_ms / 1000 * sample_rate),
            hop_length=int(hop_ms / 1000 * sample_rate),
            n_mels=n_mels,
            **kw,
        )

    def num_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self.hop_length


@functools.lru_cache(maxsize=None)
def _constants(cfg: FrontendConfig, device: torch.device, dtype: torch.dtype):
    """Device-resident constants, built once per (config, device, dtype) and
    never freed (a captured step's CUDA graph reads them,
    :mod:`titanet_torch.train.capture`): (window [n_fft], cos [n_fft,
    bins], sin [n_fft, bins], windowed basis [2, n_fft, bins], mel fb
    [bins, n_mels])."""
    n_bins = cfg.n_fft // 2 + 1
    cos_m, sin_m = _dft_matrices(cfg.n_fft)
    window = padded_window(cfg.n_fft, cfg.win_length)
    w64 = window.astype(np.float64)[:, None]
    basis = np.stack([cos_m * w64, sin_m * w64]).astype(np.float32)
    fb = mel_filterbank(n_bins, cfg.n_mels, cfg.sample_rate)

    def dev(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return dev(window), dev(cos_m), dev(sin_m), dev(basis, dtype), dev(fb, dtype)


def _padded_buffer(
    x: torch.Tensor, pad: int, extra: int, lengths: Optional[torch.Tensor]
) -> torch.Tensor:
    """Center-padded buffer ``[B, pad + T + pad + extra]``: reflection at the
    left edge (every utterance starts at 0) and at each utterance's TRUE
    right edge (a gather of ``pad`` samples per row and a scatter)."""
    b, t = x.shape
    left = x[:, 1 : pad + 1].flip(-1)
    if lengths is None:
        right = x[:, t - pad - 1 : t - 1].flip(-1)
        return torch.cat([left, x, right, x.new_zeros(b, extra)], dim=-1)
    buf = torch.cat([left, x, x.new_zeros(b, pad + extra)], dim=-1)
    ln = lengths.to(device=x.device, dtype=torch.long)
    # tail[j] = x[len - 2 - j]: a reversed slice ending at len - 1, its start
    # clipped into the row (a clamped reflection for len <= pad, where
    # torch.stft itself refuses the input)
    start = (ln - 1 - pad).clamp(0, t - pad)
    j = torch.arange(pad, device=x.device)
    tail = torch.gather(x, 1, start[:, None] + (pad - 1 - j)[None, :])
    # the update lands at pad + len, clamped so it stays inside the row
    pos = (pad + ln).clamp(max=buf.shape[1] - pad)
    return buf.scatter(1, pos[:, None] + j[None, :], tail)


def _framing_buffer(
    x: torch.Tensor, n_fft: int, hop_length: int, lengths: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, int, int]:
    """Center-reflect-padded buffer covering all frames:
    ``(buf [B, >= (n_frames-1)*hop + k*hop], n_frames, k_slices)``."""
    b, t = x.shape
    pad = n_fft // 2
    if t <= pad:
        raise ValueError(
            f"input length {t} must exceed n_fft//2={pad} for reflect padding "
            "(same constraint as torch.stft center=True)"
        )
    n_frames = 1 + t // hop_length
    k_slices = -(-n_fft // hop_length)
    need = (n_frames - 1 + k_slices) * hop_length
    extra = max(need - (t + 2 * pad), 0)
    return _padded_buffer(x, pad, extra, lengths), n_frames, k_slices


def frame_signal(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Center-reflect-pad then extract frames: ``[B, T] -> [B, F, n_fft]``
    with ``F = 1 + T // hop`` (torch.stft center=True semantics)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    buf, n_frames, _ = _framing_buffer(x, n_fft, hop_length, lengths)
    frames = buf.unfold(1, n_fft, hop_length)[:, :n_frames]
    return frames[0] if squeeze else frames


def spectrogram(
    waveform: torch.Tensor,
    cfg: FrontendConfig,
    power: float = 2.0,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[..., T] -> [..., F, n_bins]`` power spectrogram, torch.stft
    compatible, with the DFT as two f32 matmuls."""
    window, cos_m, sin_m, _, _ = _constants(cfg, waveform.device, torch.float32)
    frames = frame_signal(waveform, cfg.n_fft, cfg.hop_length, lengths=lengths)
    frames = frames * window
    re = frames @ cos_m
    im = frames @ sin_m
    p = re * re + im * im
    return p if power == 2.0 else p ** (power / 2.0)


def amplitude_to_db(power_spec: torch.Tensor, amin: float = 1e-10) -> torch.Tensor:
    """torchaudio AmplitudeToDB (power, ref=1.0, no top_db)."""
    return 10.0 * torch.log10(torch.clamp(power_spec, min=amin))


def l2_normalize_mels(spec_db: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize over the mel axis (the last axis)."""
    norm = torch.linalg.vector_norm(spec_db, dim=-1, keepdim=True)
    return spec_db / torch.clamp(norm, min=eps)


def frame_mask(lengths: torch.Tensor, n_frames: int, hop_length: int) -> torch.Tensor:
    """``[B, F]`` f32 mask: 1 for frames ``< 1 + length // hop``."""
    frame_ids = torch.arange(n_frames, device=lengths.device)[None, :]
    valid = 1 + lengths.to(torch.long)[:, None] // hop_length
    return (frame_ids < valid).to(torch.float32)


def log_mel_fused_operands(
    waveform: torch.Tensor, cfg: FrontendConfig, lengths: Optional[torch.Tensor]
):
    """``(args, kwargs)`` of the fused log-mel kernel
    (:func:`titanet_torch.ops.kernels.melspec.log_mel_fused`) for
    ``waveform [B, T]`` f32: the framing buffer in the kernel's dtype, the
    int32 lengths, the basis and the filterbank; ``n_frames``, ``hop`` and
    ``win_length``."""
    dtype = torch.float32 if cfg.precision == "highest" else torch.bfloat16
    buf, n_frames, _ = _framing_buffer(waveform, cfg.n_fft, cfg.hop_length, lengths)
    _, _, _, basis, fb = _constants(cfg, waveform.device, dtype)
    lens = None if lengths is None else lengths.to(torch.int32).contiguous()
    return (buf.to(dtype).contiguous(), lens, basis, fb), dict(
        n_frames=n_frames, hop=cfg.hop_length, win_length=cfg.win_length
    )


def _log_mel_fused(
    waveform: torch.Tensor, cfg: FrontendConfig, lengths: Optional[torch.Tensor]
) -> torch.Tensor:
    from titanet_torch.ops.kernels.melspec import log_mel_fused

    args, kwargs = log_mel_fused_operands(waveform, cfg, lengths)
    return log_mel_fused(*args, **kwargs)


def log_mel_spectrogram(
    waveform: torch.Tensor,
    cfg: FrontendConfig,
    lengths: Optional[torch.Tensor] = None,
    mel_fb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full frontend: ``[B, T] -> ([B, F, n_mels], frames_mask [B, F])``.

    ``cfg.use_pallas_fused`` routes through the fused kernel unless the
    caller supplies ``mel_fb`` (the kernel uses its own filterbank).
    """
    if lengths is not None:
        lengths = lengths.to(waveform.device)
    squeeze = waveform.dim() == 1
    x = waveform[None] if squeeze else waveform
    x = x.to(torch.float32)
    fused = cfg.use_pallas_fused and mel_fb is None
    if fused:
        out = _log_mel_fused(x, cfg, lengths)  # zeroes masked frames itself
    else:
        if mel_fb is None:
            mel_fb = _constants(cfg, x.device, torch.float32)[4]
        p = spectrogram(x, cfg, power=2.0, lengths=lengths)
        out = l2_normalize_mels(amplitude_to_db(p @ mel_fb.to(p.dtype)))
    mask = None
    if lengths is not None:
        mask = frame_mask(lengths, out.shape[-2], cfg.hop_length)
        if not fused:
            out = out * mask[..., None]
    if squeeze:
        out = out[0]
        mask = mask[0] if mask is not None else None
    return out, mask
