"""The two log-mel kernels: wrappers, plain versions and launch counts.

- :func:`log_mel_fused`, CUDA source ``titanet_torch/csrc/logmel.cu``
  (replaces ``titanet_tpu/ops/pallas/melspec.py::
  log_mel_spectrogram_pallas_fused``): takes the reflect-padded buffer that
  ``ops/frontend.py::_framing_buffer`` builds and returns the normalized
  log-mel ``[B, F, n_mels]`` (f32), with frames at or after
  ``1 + length // hop`` zeroed when ``lengths`` is given. No frames tensor
  exists.
- :func:`log_mel_frames`, CUDA source ``titanet_torch/csrc/mel_frames.cu``
  (replaces ``..melspec.py::_mel_frames_pallas``): takes materialized
  frames ``[N, n_fft]`` (f32) and returns ``[N, n_mels]``;
  :func:`log_mel_spectrogram_pallas` is the frontend built on it (plain
  torch framing and frame mask around the kernel).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from titanet_torch.ops import frontend
from titanet_torch.ops.kernels import _build

TILE_FRAMES = 64  # frames per block; csrc/logmel.cu kTileFrames
MAX_SMEM = 232448


def smem_bytes(hop: int, n_fft: int, n_mels: int) -> int:
    """Dynamic shared memory one block of the kernel needs."""
    span = (TILE_FRAMES - 1) * hop + n_fft
    return (max(span, TILE_FRAMES * n_mels) + TILE_FRAMES * (n_fft // 2 + 1)) * 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("logmel")
    args = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    for fn in (lib.titanet_logmel_f32, lib.titanet_logmel_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.titanet_logmel_error_string.argtypes = [ctypes.c_int]
    lib.titanet_logmel_error_string.restype = ctypes.c_char_p
    return lib


def _window_taps(n_fft: int, win_length: int):
    """[k_lo, k_hi): the basis rows the centred window leaves non-zero."""
    k_lo = (n_fft - win_length) // 2
    return k_lo, k_lo + win_length


def _check(buf, lengths, basis, fb, n_frames, hop):
    if buf.dim() != 2 or basis.dim() != 3 or basis.shape[0] != 2 or fb.dim() != 2:
        raise ValueError("expected buf [B, L], basis [2, n_fft, n_bins], fb [n_bins, n_mels]")
    if buf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"buf must be float32 or bfloat16, got {buf.dtype}")
    if basis.dtype != buf.dtype or fb.dtype != buf.dtype:
        raise TypeError("buf, basis and fb must share one dtype")
    n_fft, n_bins = basis.shape[1], basis.shape[2]
    if n_bins != n_fft // 2 + 1 or fb.shape[0] != n_bins:
        raise ValueError("basis/fb shapes do not match n_fft")
    if buf.shape[1] < (n_frames - 1) * hop + n_fft:
        raise ValueError("buffer is shorter than (n_frames - 1) * hop + n_fft")
    tensors = [buf, basis, fb] + ([lengths] if lengths is not None else [])
    if any(t.device != buf.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if lengths is not None and (lengths.dtype != torch.int32 or lengths.shape != (buf.shape[0],)):
        raise ValueError("lengths must be int32 [B]")


def log_mel_fused_plain(
    buf: torch.Tensor,
    lengths: Optional[torch.Tensor],
    basis: torch.Tensor,
    fb: torch.Tensor,
    *,
    n_frames: int,
    hop: int,
) -> torch.Tensor:
    """Plain torch version of the kernel, the same arithmetic in f32:
    bf16 inputs are widened exactly and the power is rounded to bf16 before
    the filterbank product, as in the kernel's bf16 mode."""
    n_fft = basis.shape[1]
    frames = buf.unfold(1, n_fft, hop)[:, :n_frames].float()
    b32 = basis.float()
    re = frames @ b32[0]
    im = frames @ b32[1]
    if buf.dtype == torch.bfloat16:
        p = (re * re).bfloat16().float() + (im * im).bfloat16().float()
    else:
        p = re * re + im * im
    db = 10.0 * torch.log10(torch.clamp(p @ fb.float(), min=1e-10))
    nrm = torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-12)
    out = db / nrm
    if lengths is not None:
        frame_ids = torch.arange(n_frames, device=buf.device)[None, :]
        valid = 1 + lengths.long()[:, None] // hop
        out = out * (frame_ids < valid)[..., None].float()
    return out


def log_mel_fused(
    buf: torch.Tensor,
    lengths: Optional[torch.Tensor],
    basis: torch.Tensor,
    fb: torch.Tensor,
    *,
    n_frames: int,
    hop: int,
    win_length: Optional[int] = None,
) -> torch.Tensor:
    """``buf [B, L]`` (f32 or bf16), ``basis [2, n_fft, n_bins]`` (window
    folded in), ``fb [n_bins, n_mels]`` -> normalized log-mel
    ``[B, n_frames, n_mels]`` f32. ``win_length`` lets the kernel skip the
    basis rows the window zeroes (the default reads all ``n_fft``)."""
    _check(buf, lengths, basis, fb, n_frames, hop)
    if buf.device.type == "cpu":
        return log_mel_fused_plain(buf, lengths, basis, fb, n_frames=n_frames, hop=hop)
    if buf.device.type != "cuda":
        raise RuntimeError(f"no fused log-mel kernel for device {buf.device}")
    n_fft, n_mels = basis.shape[1], fb.shape[1]
    if smem_bytes(hop, n_fft, n_mels) > MAX_SMEM:
        raise ValueError(
            f"n_fft={n_fft}, hop={hop}: a {TILE_FRAMES}-frame tile does not fit "
            "in shared memory"
        )
    k_lo, k_hi = _window_taps(n_fft, win_length if win_length else n_fft)
    out = torch.empty(buf.shape[0], n_frames, n_mels, device=buf.device, dtype=torch.float32)
    lib = _lib()
    fn = lib.titanet_logmel_f32 if buf.dtype == torch.float32 else lib.titanet_logmel_bf16
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        code = fn(
            buf.data_ptr(), buf.stride(0), buf.shape[1], buf.shape[0],
            lengths.data_ptr() if lengths is not None else None,
            basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
            n_frames, hop, n_fft, k_lo, k_hi, n_mels, stream,
        )
    if code != 0:
        raise RuntimeError(
            f"log-mel kernel launch failed: {lib.titanet_logmel_error_string(code).decode()}"
        )
    log_mel_fused.launches += 1
    return out


log_mel_fused.launches = 0


# ---------------------------------------------------------- frames kernel


@functools.lru_cache(maxsize=None)
def _frames_lib() -> ctypes.CDLL:
    lib = _build.load("mel_frames")
    for fn in (lib.titanet_mel_frames_f32, lib.titanet_mel_frames_bf16):
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.titanet_mel_frames_error_string.argtypes = [ctypes.c_int]
    lib.titanet_mel_frames_error_string.restype = ctypes.c_char_p
    return lib


def frames_smem_bytes(taps: int, n_fft: int, n_mels: int) -> int:
    """Dynamic shared memory one block of the frames kernel needs."""
    return (TILE_FRAMES * max(taps, n_mels) + TILE_FRAMES * (n_fft // 2 + 1)) * 4


def _operand_dtype(precision: str) -> torch.dtype:
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    return torch.float32 if precision == "highest" else torch.bfloat16


def _check_frames(frames, basis, fb, precision):
    dtype = _operand_dtype(precision)
    if frames.dim() != 2 or basis.dim() != 3 or basis.shape[0] != 2 or fb.dim() != 2:
        raise ValueError("expected frames [N, n_fft], basis [2, n_fft, n_bins], fb [n_bins, n_mels]")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if basis.dtype != dtype or fb.dtype != dtype:
        raise TypeError(f"precision {precision!r} takes basis and fb in {dtype}")
    n_fft, n_bins = basis.shape[1], basis.shape[2]
    if frames.shape[1] != n_fft or n_bins != n_fft // 2 + 1 or fb.shape[0] != n_bins:
        raise ValueError("frames/basis/fb shapes do not match n_fft")
    if any(t.device != frames.device for t in (basis, fb)):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in (frames, basis, fb)):
        raise ValueError("inputs must be contiguous")


def log_mel_frames_plain(
    frames: torch.Tensor, basis: torch.Tensor, fb: torch.Tensor, *, precision: str = "highest"
) -> torch.Tensor:
    """Plain torch version of the frames kernel, the same arithmetic in
    f32. Under ``"default"`` the operands of both products are rounded to
    bf16 first (the frames here, the power before the filterbank product;
    basis and fb arrive in bf16) and widened exactly."""
    _operand_dtype(precision)
    b32 = basis.float()
    f = frames if precision == "highest" else frames.bfloat16().float()
    re = f @ b32[0]
    im = f @ b32[1]
    if precision == "highest":
        p = re * re + im * im
    else:
        p = (re * re).bfloat16().float() + (im * im).bfloat16().float()
    db = 10.0 * torch.log10(torch.clamp(p @ fb.float(), min=1e-10))
    nrm = torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-12)
    return db / nrm


def log_mel_frames(
    frames: torch.Tensor,
    basis: torch.Tensor,
    fb: torch.Tensor,
    *,
    precision: str = "highest",
    win_length: Optional[int] = None,
) -> torch.Tensor:
    """``frames [N, n_fft]`` f32, ``basis [2, n_fft, n_bins]`` (window
    folded in), ``fb [n_bins, n_mels]`` -> normalized log-mel
    ``[N, n_mels]`` f32. ``precision`` ``"highest"``: f32 operands (basis
    and fb in f32); ``"default"``: operands rounded to bf16, f32
    accumulation (basis and fb in bf16; the frames stay f32 in device
    memory and are rounded in the kernel). ``win_length`` lets the kernel
    skip the basis rows the window zeroes."""
    _check_frames(frames, basis, fb, precision)
    if frames.device.type == "cpu":
        return log_mel_frames_plain(frames, basis, fb, precision=precision)
    if frames.device.type != "cuda":
        raise RuntimeError(f"no frames log-mel kernel for device {frames.device}")
    n_fft, n_mels = basis.shape[1], fb.shape[1]
    k_lo, k_hi = _window_taps(n_fft, win_length if win_length else n_fft)
    if frames_smem_bytes(k_hi - k_lo, n_fft, n_mels) > MAX_SMEM:
        raise ValueError(
            f"n_fft={n_fft}: a {TILE_FRAMES}-frame tile does not fit in shared memory"
        )
    out = torch.empty(frames.shape[0], n_mels, device=frames.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _frames_lib()
    fn = lib.titanet_mel_frames_f32 if precision == "highest" else lib.titanet_mel_frames_bf16
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        code = fn(
            frames.data_ptr(), frames.shape[0], basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
            n_fft, k_lo, k_hi, n_mels, stream,
        )
    if code != 0:
        raise RuntimeError(
            f"frames log-mel kernel launch failed: "
            f"{lib.titanet_mel_frames_error_string(code).decode()}"
        )
    log_mel_frames.launches += 1
    return out


log_mel_frames.launches = 0


def log_mel_spectrogram_pallas(
    waveform: torch.Tensor,
    cfg: frontend.FrontendConfig,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Drop-in replacement for
    :func:`titanet_torch.ops.frontend.log_mel_spectrogram`
    (``[B, T] -> ([B, F, n_mels], frames_mask [B, F])``): plain torch cuts
    the ``[B, F, n_fft]`` frames, :func:`log_mel_frames` does DFT, power,
    mel, dB and L2 on them, and the frame mask zeroes the padded frames
    outside the kernel."""
    if lengths is not None:
        lengths = lengths.to(waveform.device)
    x = waveform.to(torch.float32)
    b = x.shape[0]
    frames = frontend.frame_signal(x, cfg.n_fft, cfg.hop_length, lengths=lengths)
    n_frames = frames.shape[1]
    _, _, _, basis, fb = frontend._constants(cfg, x.device, _operand_dtype(cfg.precision))
    out = log_mel_frames(
        frames.reshape(b * n_frames, cfg.n_fft), basis, fb,
        precision=cfg.precision, win_length=cfg.win_length,
    ).reshape(b, n_frames, cfg.n_mels)
    mask = None
    if lengths is not None:
        mask = frontend.frame_mask(lengths, n_frames, cfg.hop_length)
        out = out * mask[..., None]
    return out, mask
