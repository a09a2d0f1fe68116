"""Fused mega-block sub-chain kernel: wrapper, plain version, launch count.

CUDA source: ``titanet_torch/csrc/megablock.cu`` (replaces
``titanet_tpu/ops/pallas/megablock.py::fused_sub_blocks``). One launch
computes a mega-block's chain

    (depthwise k + bias -> pointwise C x C product + bias -> folded-BN
     affine -> relu) x S

on ``x [B, T, C]`` without writing an intermediate activation to device
memory. Inference only: no gradient.

One kernel holds a time tile of the activations in shared memory, runs the
depthwise pass on every thread and the pointwise products on the tensor
cores while ``cp.async`` streams the weights through a ring of slabs. bf16
multiplies with ``wgmma`` at C = 256 and 512 and ``mma.sync`` from
``ldmatrix`` fragments at C = 128 and 1024 (``csrc/mma_bf16.cuh``). f32,
the parity surface, keeps f32 tiles and splits each operand into two TF32
parts, ``hi = rna(x)`` and ``lo = rna(x - hi)``, adding ``a_lo*b_hi +
a_hi*b_lo + a_hi*b_hi`` with ``mma.sync.m16n8k8`` ("3xTF32": about 21 bits
a term, an f32 product's error) at C = 128, 256 and 512 (at 512 with one
activation buffer in place); at C = 1024, where not even that fits shared
memory, the FP32-core design runs.
:data:`TC_TILES`, :data:`F32_TILES`, :func:`tile_rows`, :func:`smem_bytes`,
:func:`kernel_supports` and :func:`kernel_design` mirror the tile geometry
of the three.

Edge rows. As in the kernel it replaces, only the INPUT is zero outside
``[0, T)``: every stage is also evaluated on the halo rows and is not
re-zeroed there, so stage ``s+1`` at row 0 reads stage ``s`` at row ``-1``
as ``relu(bn(pw(dw_b) + pw_b))`` where a chain of zero-padded convolutions
would read 0. The first and last ``(S-1)*pad`` output rows therefore
differ from ``TitaNet``'s per-conv path; every other row is the same.

On a CPU tensor :func:`fused_sub_blocks` runs
:func:`fused_sub_blocks_plain`; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from titanet_torch.ops.kernels import _build

MAX_SMEM = 232448
# bf16 (tensor-core kernels), by channel count: (instruction, rows RM, output
# columns a pass NC, rows a weight slab KS, ring stages NST)
# (csrc/megablock.cu::Tc* and Wg*)
TC_TILES = {128: ("mma.sync", 64, 128, 32, 3), 256: ("wgmma", 128, 256, 32, 4),
            512: ("wgmma", 64, 512, 16, 4), 1024: ("mma.sync", 32, 512, 16, 3)}
# f32, by channel count: (design, rows RM, output columns a pass NC, rows a
# weight slab KS, ring stages NST) (csrc/megablock.cu::Tf*: two activation
# buffers, or one "in place"; at C = 1024 the FP32-core megablock_kernel: one
# chunk of all C columns, a slab of 8192 floats copied between two barriers)
F32_TILES = {128: ("3xTF32", 64, 128, 32, 3), 256: ("3xTF32", 80, 256, 16, 2),
             512: ("3xTF32 in place", 64, 512, 16, 2), 1024: ("fp32-core", 32, 1024, 8, 1)}
_SMEM_ROW_PAD = 8  # bf16 elements (csrc/mma_bf16.cuh::kPad)
_F32_A_PAD, _F32_W_PAD = 4, 8  # floats: activation and weight-slab row padding (Tf32Cfg)


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm in eval mode -> per-channel ``(scale', shift')``."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def tile_rows(channels: int, dtype) -> int:
    """Rows RM of the largest stage output a block computes; a tile is
    ``RM - 2*pad*(S-1)`` output rows."""
    return (TC_TILES if dtype == torch.bfloat16 else F32_TILES)[channels][1]


def kernel_design(dtype, channels: int) -> str:
    """Which of the source's kernels a dtype and width run."""
    if dtype != torch.bfloat16:
        design = F32_TILES[channels][0]
        if design == "fp32-core":
            return design
        return "tensor-core, 3xTF32 mma.sync" + (", in place" if design.endswith("in place") else "")
    return f"tensor-core, {TC_TILES[channels][0]}"


def smem_bytes(channels: int, kernel_size: int, dtype) -> int:
    """Dynamic shared memory one block of the kernel needs."""
    pad = (kernel_size - 1) // 2
    if dtype == torch.bfloat16:
        # depthwise buffer (RM rows; padded for mma.sync, swizzled panels for
        # wgmma) + input buffer (RM + 2*pad padded rows) + weight ring, bf16;
        # a stage's pw_b, scale and shift, f32
        insn, rm, nc, ks, nst = TC_TILES[channels]
        padded = channels + _SMEM_ROW_PAD
        if insn == "wgmma":
            elems = rm * channels + (rm + 2 * pad) * padded + nst * ks * nc
        else:
            elems = (2 * rm + 2 * pad) * padded + nst * ks * (nc + _SMEM_ROW_PAD)
        return elems * 2 + 3 * channels * 4
    design, rm, nc, ks, nst = F32_TILES[channels]
    if design == "fp32-core":  # one buffer of RM + 2*pad rows and one weight slab
        return ((rm + 2 * pad) * channels + ks * channels) * 4
    # depthwise buffer (RM rows; none in place) + input buffer (RM + 2*pad
    # rows), padded, + weight ring, f32; a stage's pw_b, scale and shift
    padded = channels + _F32_A_PAD
    buffer_rows = (rm + 2 * pad) + (0 if design.endswith("in place") else rm)
    elems = buffer_rows * padded + nst * ks * (nc + _F32_W_PAD)
    return elems * 4 + 3 * channels * 4


def kernel_supports(channels: int, kernel_size: int, n_stages: int, dtype) -> bool:
    """What the CUDA kernels take: f32 or bf16, C in 128/256/512/1024, odd
    k, and a time tile of at least 8 rows that fits shared memory (TitaNet
    S, M and L do: (C, k) = (256, 3), (512, 7), (1024, 11), S = 3)."""
    if dtype not in (torch.float32, torch.bfloat16) or channels not in TC_TILES:
        return False
    if kernel_size < 1 or kernel_size % 2 == 0 or n_stages < 1:
        return False
    tile = tile_rows(channels, dtype) - (kernel_size - 1) * (n_stages - 1)
    return tile >= 8 and smem_bytes(channels, kernel_size, dtype) <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("megablock")
    for fn in (lib.titanet_megablock_f32, lib.titanet_megablock_bf16):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.titanet_megablock_error_string.argtypes = [ctypes.c_int]
    lib.titanet_megablock_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dw_w, dw_b, pw_w, pw_b, bn, kernel_size):
    if x.dim() != 3:
        raise ValueError("expected x [B, T, C]")
    c = x.shape[-1]
    s = dw_w.shape[0]
    shapes = {
        "dw_w": (dw_w, (s, kernel_size, c)), "dw_b": (dw_b, (s, c)),
        "pw_w": (pw_w, (s, c, c)), "pw_b": (pw_b, (s, c)), "bn": (bn, (s, 2, c)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if kernel_size % 2 == 0:
        raise ValueError("kernel_size must be odd")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if pw_w.dtype != x.dtype:
        raise TypeError("pw_w must have x's dtype")
    if any(t.dtype != torch.float32 for t in (dw_w, dw_b, pw_b, bn)):
        raise TypeError("dw_w, dw_b, pw_b and bn must be float32")
    tensors = (x, dw_w, dw_b, pw_w, pw_b, bn)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def fused_sub_blocks_plain(
    x: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    pw_w: torch.Tensor,
    pw_b: torch.Tensor,
    bn: torch.Tensor,
    kernel_size: int,
) -> torch.Tensor:
    """Plain torch version of the kernel, the same arithmetic: the input is
    zero-padded by ``S*pad`` rows a side ONCE and the S stages run as
    "valid" convolutions, so the length comes back to T and the halo rows
    carry real values between stages. The depthwise sum is rounded to
    ``x.dtype`` before the product (f32 accumulation), the stage's output
    after the relu."""
    pad = (kernel_size - 1) // 2
    n_stages = dw_w.shape[0]
    halo = n_stages * pad
    h = F.pad(x, (0, 0, halo, halo))
    for s in range(n_stages):
        rows = h.shape[1] - 2 * pad
        acc = torch.zeros(x.shape[0], rows, x.shape[2], dtype=torch.float32, device=x.device)
        for j in range(kernel_size):
            acc = acc + h[:, j : j + rows].float() * dw_w[s, j]
        acc = acc + dw_b[s]
        acc = acc.to(x.dtype).float() @ pw_w[s].float()
        acc = (acc + pw_b[s]) * bn[s, 0] + bn[s, 1]
        h = torch.relu(acc).to(x.dtype)
    return h


def fused_sub_blocks(
    x: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    pw_w: torch.Tensor,
    pw_b: torch.Tensor,
    bn: torch.Tensor,
    kernel_size: int,
) -> torch.Tensor:
    """``x [B, T, C]`` (f32 or bf16) -> ``[B, T, C]``: a mega-block's fused
    sub-block chain. ``dw_w [S, k, C]`` depthwise taps, ``dw_b [S, C]``,
    ``pw_b [S, C]``, ``bn [S, 2, C]`` folded (scale', shift'), all f32;
    ``pw_w [S, C, C]`` pointwise (in, out) in ``x.dtype``."""
    _check(x, dw_w, dw_b, pw_w, pw_b, bn, kernel_size)
    if x.device.type == "cpu":
        return fused_sub_blocks_plain(x, dw_w, dw_b, pw_w, pw_b, bn, kernel_size)
    if x.device.type != "cuda":
        raise RuntimeError(f"no fused mega-block kernel for device {x.device}")
    b, t, c = x.shape
    n_stages = dw_w.shape[0]
    if not kernel_supports(c, kernel_size, n_stages, x.dtype):
        raise ValueError(
            f"the mega-block kernel does not take C={c}, k={kernel_size}, S={n_stages}, "
            f"{x.dtype} (see kernel_supports)"
        )
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _lib()
    fn = lib.titanet_megablock_f32 if x.dtype == torch.float32 else lib.titanet_megablock_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(), pw_b.data_ptr(),
            bn.data_ptr(), out.data_ptr(), b, t, c, n_stages, kernel_size, stream,
        )
    if code != 0:
        raise RuntimeError(
            f"mega-block kernel launch failed: {lib.titanet_megablock_error_string(code).decode()}"
        )
    fused_sub_blocks.launches += 1
    return out


fused_sub_blocks.launches = 0
