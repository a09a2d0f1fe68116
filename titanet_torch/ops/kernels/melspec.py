"""The two log-mel kernels: wrappers, plain versions and launch counts.

- :func:`log_mel_fused`, CUDA source ``titanet_torch/csrc/logmel.cu``
  (replaces ``titanet_tpu/ops/pallas/melspec.py::
  log_mel_spectrogram_pallas_fused``): takes the reflect-padded buffer that
  ``ops/frontend.py::_framing_buffer`` builds and returns the normalized
  log-mel ``[B, F, n_mels]`` (f32), with frames at or after
  ``1 + length // hop`` zeroed when ``lengths`` is given. No frames tensor
  exists. bf16 runs on the tensor cores (``logmel_tc_kernel``, basis and
  filterbank rearranged once per tensor: :func:`tc_basis`,
  :func:`fused_tc_filterbank`) wherever :func:`fused_tc_supports` holds,
  f32 and any other bf16 geometry on the FP32 cores (``logmel_kernel``).
- :func:`log_mel_frames`, CUDA source ``titanet_torch/csrc/mel_frames.cu``
  (replaces ``..melspec.py::_mel_frames_pallas``): takes materialized
  frames ``[N, n_fft]`` (f32) and returns ``[N, n_mels]``;
  :func:`log_mel_spectrogram_pallas` is the frontend built on it (plain
  torch framing and frame mask around the kernel). Its "default" route runs
  on the bf16 tensor cores, with the basis and filterbank rearranged once
  per tensor (:func:`tc_basis`, :func:`tc_filterbank`).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.utils.weak import WeakTensorKeyDictionary

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
    lib.titanet_logmel_bf16_tc.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.titanet_logmel_bf16_tc.restype = ctypes.c_int
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
    basis rows the window zeroes (the default reads all ``n_fft``).
    ``log_mel_fused.launches`` counts every launch,
    ``log_mel_fused.tc_launches`` those of the tensor-core kernel."""
    _check(buf, lengths, basis, fb, n_frames, hop)
    if buf.device.type == "cpu":
        return log_mel_fused_plain(buf, lengths, basis, fb, n_frames=n_frames, hop=hop)
    if buf.device.type != "cuda":
        raise RuntimeError(f"no fused log-mel kernel for device {buf.device}")
    n_fft, n_bins, n_mels = basis.shape[1], basis.shape[2], fb.shape[1]
    win_length = win_length if win_length else n_fft
    tc = buf.dtype == torch.bfloat16 and fused_tc_supports(n_fft, win_length, n_mels)
    if not tc and smem_bytes(hop, n_fft, n_mels) > MAX_SMEM:
        raise ValueError(
            f"n_fft={n_fft}, hop={hop}: a {TILE_FRAMES}-frame tile does not fit "
            "in shared memory"
        )
    k_lo, k_hi = _window_taps(n_fft, win_length)
    out = torch.empty(buf.shape[0], n_frames, n_mels, device=buf.device, dtype=torch.float32)
    lib = _lib()
    lens = lengths.data_ptr() if lengths is not None else None
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        if tc:
            k0, taps = tc_taps(k_lo, k_hi)
            panels = _tc_cached(basis, (k0, k_hi), lambda: tc_basis(basis, k0, k_hi))
            fbd = _tc_cached(fb, "fused", lambda: fused_tc_filterbank(fb))
            code = lib.titanet_logmel_bf16_tc(
                buf.data_ptr(), buf.stride(0), buf.shape[0], lens, panels.data_ptr(),
                fbd.data_ptr(), out.data_ptr(), n_frames, hop, k0, taps, n_bins, n_mels, stream,
            )
        else:
            fn = lib.titanet_logmel_f32 if buf.dtype == torch.float32 else lib.titanet_logmel_bf16
            code = fn(
                buf.data_ptr(), buf.stride(0), buf.shape[1], buf.shape[0], lens,
                basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
                n_frames, hop, n_fft, k_lo, k_hi, n_mels, stream,
            )
    if code != 0:
        raise RuntimeError(
            f"log-mel kernel launch failed: {lib.titanet_logmel_error_string(code).decode()}"
        )
    log_mel_fused.launches += 1
    log_mel_fused.tc_launches += tc
    return out


log_mel_fused.launches = 0
log_mel_fused.tc_launches = 0


@torch.library.custom_op("titanet_torch::log_mel_fused", mutates_args=())
def log_mel_fused_op(
    buf: torch.Tensor,
    lengths: Optional[torch.Tensor],
    basis: torch.Tensor,
    fb: torch.Tensor,
    n_frames: int,
    hop: int,
    win_length: int,
) -> torch.Tensor:
    """:func:`log_mel_fused` as the registered operator
    ``torch.ops.titanet_torch.log_mel_fused``, so that a traced graph
    (``torch.export``, :mod:`titanet_torch.utils.export`) holds the kernel
    as one node. On a CUDA tensor it launches the kernel, on a CPU tensor it
    runs the plain version: the wrapper's own device rule."""
    return log_mel_fused(buf, lengths, basis, fb, n_frames=n_frames, hop=hop, win_length=win_length)


@log_mel_fused_op.register_fake
def _log_mel_fused_fake(buf, lengths, basis, fb, n_frames, hop, win_length):
    _check(buf, lengths, basis, fb, n_frames, hop)
    return buf.new_empty((buf.shape[0], n_frames, fb.shape[1]), dtype=torch.float32)


# ---------------------------------------------------------- frames kernel


@functools.lru_cache(maxsize=None)
def _frames_lib() -> ctypes.CDLL:
    lib = _build.load("mel_frames")
    for fn, n_ints in ((lib.titanet_mel_frames_f32, 4), (lib.titanet_mel_frames_bf16, 5)):
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.titanet_mel_frames_error_string.argtypes = [ctypes.c_int]
    lib.titanet_mel_frames_error_string.restype = ctypes.c_char_p
    return lib


def frames_smem_bytes(taps: int, n_fft: int, n_mels: int) -> int:
    """Dynamic shared memory one block of the f32 frames kernel needs."""
    return (TILE_FRAMES * max(taps, n_mels) + TILE_FRAMES * (n_fft // 2 + 1)) * 4


# The bf16 tensor-core frames kernel (csrc/mel_frames.cu mel_frames_tc_kernel):
# the host-side layout of its operands and its shared memory, mirrored here.
TC_ROWS = 128  # frames a block (kTcRows)
TC_SLAB = 32  # taps a basis slab (kSlab)
TC_STAGES = (4, 3)  # basis ring depths; the deepest that fits is taken
TC_MELS = (80,)  # n_mels the kernel is built for (TitaNet's)
TC_MAX_TAPS = 512  # a lane loads four 4-tap chunks of a frame row
_TC_PAD = 8  # bf16 elements of padding a shared-memory row


def tc_taps(k_lo: int, k_hi: int):
    """``(k0, taps)``: the kernel reads taps ``[k0, k_hi)`` with ``k0`` =
    ``k_lo`` rounded down to 16, so each 16-tap product step covers the same
    taps whatever window skip the caller asks for, and the skipped steps
    would add exact zeros: with or without the skip, the same bits."""
    k0 = k_lo // 16 * 16
    return k0, k_hi - k0


def tc_layout(taps: int, n_bins: int):
    """``(tpp, n_groups, n_panels, kb)``: taps padded to a slab multiple;
    bins ``0 .. n_bins - 2`` in 8-bin groups and 128-bin panels (the
    Nyquist bin rides in bin 0's sin column); filterbank rows: 128 a panel,
    then 16 whose first is the Nyquist bin's."""
    tpp = -(-taps // TC_SLAB) * TC_SLAB
    n_groups = -(-(n_bins - 1) // 8)
    n_panels = -(-n_groups // 16)
    return tpp, n_groups, n_panels, n_panels * 128 + 16


def tc_smem_bytes(taps: int, n_bins: int, n_mels: int, stages: int) -> int:
    """Dynamic shared memory of a block: the frames tile (64-tap panels of
    128 rows), the basis ring (16 KB a stage) and the filterbank (rows padded
    by 8), bf16."""
    tpp, _, _, kb = tc_layout(taps, n_bins)
    return 2 * (TC_ROWS * -(-tpp // 64) * 64 + stages * TC_SLAB * 256 + kb * (n_mels + _TC_PAD))


def tc_stages(taps: int, n_bins: int, n_mels: int) -> int:
    """The ring depth the kernel takes, the deepest that fits shared
    memory; 0 where none does or the taps are more than it takes."""
    if tc_layout(taps, n_bins)[0] > TC_MAX_TAPS:
        return 0
    return next((s for s in TC_STAGES if tc_smem_bytes(taps, n_bins, n_mels, s) <= MAX_SMEM), 0)


def tc_basis(basis: torch.Tensor, k_lo: int, k_hi: int) -> torch.Tensor:
    """``[2, n_fft, n_bins]`` -> panels ``[n_panels, tpp, 256]`` bf16: tap
    ``t`` is basis row ``k_lo + t``; column ``16 g + 8 s + j`` of panel ``p``
    is bin ``128 p + 8 g + j`` (of ``0 .. n_bins - 2``), cos for ``s = 0``,
    sin for ``s = 1``; bin 0's sin column (zero) holds the cos column of
    the Nyquist bin, whose sin column (the rounding residue of sin(pi t))
    is left out; zero past the taps and the bins."""
    taps, n_bins = k_hi - k_lo, basis.shape[2]
    tpp, _, n_panels, _ = tc_layout(taps, n_bins)
    cs = basis.new_zeros(2, tpp, n_panels * 128, dtype=torch.bfloat16)
    cs[:, :taps, : n_bins - 1] = basis[:, k_lo:k_hi, : n_bins - 1]
    cs[1, :taps, 0] = basis[0, k_lo:k_hi, n_bins - 1]
    cs = cs.reshape(2, tpp, n_panels, 16, 8).permute(2, 1, 3, 0, 4)
    return cs.reshape(n_panels, tpp, 256).contiguous()


def tc_filterbank(fb: torch.Tensor) -> torch.Tensor:
    """``[n_bins, n_mels]`` -> ``[kb, n_mels]`` bf16: the rows of bins
    ``0 .. n_bins - 2``, then at ``n_panels * 128`` the Nyquist bin's; zero
    elsewhere."""
    n_bins = fb.shape[0]
    _, _, n_panels, kb = tc_layout(1, n_bins)
    out = fb.new_zeros(kb, fb.shape[1], dtype=torch.bfloat16)
    out[: n_bins - 1] = fb[: n_bins - 1]
    out[n_panels * 128] = fb[n_bins - 1]
    return out


# The bf16 tensor-core fused kernel (csrc/logmel.cu logmel_tc_kernel) takes
# the frames kernel's basis panels and tap window (tc_basis, tc_taps) and a
# filterbank of its own, one panel's rows at a time in shared memory.
FUSED_TC_FB_ROWS = 256  # doubled filterbank rows a panel (kFbRows)


def fused_tc_filterbank(fb: torch.Tensor) -> torch.Tensor:
    """``[n_bins, n_mels]`` -> ``[n_panels * 256, n_mels]`` bf16, the B
    operand of the fused kernel's mel product, which multiplies re^2 and
    im^2 (rounded to bf16 apart) of each 8-bin group at once: row
    ``256 p + 16 g + 8 s + j`` is bin ``128 p + 8 g + j``'s row (of bins
    ``0 .. n_bins - 2``), under its cos column (``s = 0``) and again under
    its sin column (``s = 1``): ``_fused_kernel``'s FB2, group by group.
    Row 8, bin 0's sin slot, is the Nyquist bin's row (bin 0's im is
    exactly zero; its slot carries the Nyquist bin's cos). Zero past the
    bins."""
    n_bins = fb.shape[0]
    _, _, n_panels, _ = tc_layout(1, n_bins)
    rows = fb.new_zeros(n_panels * 128, fb.shape[1], dtype=torch.bfloat16)
    rows[: n_bins - 1] = fb[: n_bins - 1]
    out = rows.reshape(n_panels * 16, 1, 8, -1).expand(-1, 2, -1, -1).clone()
    out[0, 1, 0] = fb[n_bins - 1]
    return out.reshape(n_panels * FUSED_TC_FB_ROWS, fb.shape[1])


def fused_tc_smem_bytes(taps: int, n_mels: int, stages: int) -> int:
    """Dynamic shared memory of a block of the fused tensor-core kernel: the
    frames tile (64-tap panels of 128 rows), the basis ring (16 KB a stage)
    and one panel's filterbank rows (padded by 8), bf16."""
    tpp = tc_layout(taps, 2)[0]
    return 2 * (TC_ROWS * -(-tpp // 64) * 64 + stages * TC_SLAB * 256
                + FUSED_TC_FB_ROWS * (n_mels + _TC_PAD))


def fused_tc_stages(taps: int, n_bins: int, n_mels: int) -> int:
    """The ring depth the fused kernel takes: the deepest that fits shared
    memory and, with two panels or more, lets a panel's filterbank rows,
    copied at its first slab, land before its last (``stages - 1`` slabs a
    panel at least); 0 where none does, the taps are more than it takes, or
    ``n_mels`` is not one it is built for."""
    tpp, _, n_panels, _ = tc_layout(taps, n_bins)
    if n_mels not in TC_MELS or tpp > TC_MAX_TAPS:
        return 0
    return next((s for s in TC_STAGES if fused_tc_smem_bytes(taps, n_mels, s) <= MAX_SMEM
                 and (n_panels == 1 or tpp // TC_SLAB >= s - 1)), 0)


def fused_tc_supports(n_fft: int, win_length: int, n_mels: int) -> bool:
    """Whether :func:`log_mel_fused` sends bf16 at this geometry to the
    tensor-core kernel (else to ``logmel_kernel``); the hop does not
    matter."""
    _, taps = tc_taps(*_window_taps(n_fft, win_length))
    return fused_tc_stages(taps, n_fft // 2 + 1, n_mels) > 0


# tensor -> {key: (the tensor's in-place version, operand)}; an entry goes
# with its tensor
_tc_cache = WeakTensorKeyDictionary()


def _tc_cached(t: torch.Tensor, key, build):
    """``build()`` once per (tensor, key), again if the tensor was written
    in place (inference tensors cannot be)."""
    version = -1 if t.is_inference() else t._version
    per_key = _tc_cache.setdefault(t, {})
    if key not in per_key or per_key[key][0] != version:
        per_key[key] = (version, build())
    return per_key[key][1]


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
    bf16 first (the frames here, the power ``re^2 + im^2`` once, after its
    f32 sum, before the filterbank product, as ``_mel_kernel``'s
    DEFAULT-precision dot rounds it; basis and fb arrive in bf16) and widened
    exactly."""
    _operand_dtype(precision)
    b32 = basis.float()
    f = frames if precision == "highest" else frames.bfloat16().float()
    re = f @ b32[0]
    im = f @ b32[1]
    p = re * re + im * im
    if precision == "default":
        p = p.bfloat16().float()
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
    n_fft, n_bins, n_mels = basis.shape[1], basis.shape[2], fb.shape[1]
    k_lo, k_hi = _window_taps(n_fft, win_length if win_length else n_fft)
    if precision == "highest":
        fits = frames_smem_bytes(k_hi - k_lo, n_fft, n_mels) <= MAX_SMEM
    else:
        taps = tc_taps(k_lo, k_hi)[1]
        fits = n_mels in TC_MELS and tc_stages(taps, n_bins, n_mels) > 0
    if not fits:
        raise ValueError(
            f"n_fft={n_fft}, n_mels={n_mels}: the {precision!r} frames kernel's tile does not "
            "fit in shared memory or takes no such n_mels"
        )
    out = torch.empty(frames.shape[0], n_mels, device=frames.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _frames_lib()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        if precision == "highest":
            code = lib.titanet_mel_frames_f32(
                frames.data_ptr(), frames.shape[0], basis.data_ptr(), fb.data_ptr(),
                out.data_ptr(), n_fft, k_lo, k_hi, n_mels, stream,
            )
        else:
            k0, taps = tc_taps(k_lo, k_hi)
            panels = _tc_cached(basis, (k0, k_hi), lambda: tc_basis(basis, k0, k_hi))
            fbp = _tc_cached(fb, None, lambda: tc_filterbank(fb))
            code = lib.titanet_mel_frames_bf16(
                frames.data_ptr(), frames.shape[0], panels.data_ptr(), fbp.data_ptr(),
                out.data_ptr(), n_fft, k0, taps, n_bins, n_mels, stream,
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
