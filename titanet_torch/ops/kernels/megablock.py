"""Fused mega-block sub-chain kernel: wrapper, plain version, launch count.

CUDA source: ``titanet_torch/csrc/megablock.cu`` (replaces
``titanet_tpu/ops/pallas/megablock.py::fused_sub_blocks``). One launch
computes a mega-block's chain

    (depthwise k + bias -> pointwise C x C product + bias -> folded-BN
     affine -> relu) x S

on ``x [B, T, C]`` without writing an intermediate activation to device
memory. Inference only: no gradient.

At C = 128, 256 and 512 one block holds a time tile of the activations in
shared memory, runs the depthwise pass on every thread and the pointwise
products on the tensor cores while ``cp.async`` streams the weights through
a ring of slabs. bf16 multiplies with ``wgmma`` at C = 256 and 512 and
``mma.sync`` from ``ldmatrix`` fragments at C = 128 (``csrc/mma_bf16.cuh``).
f32, the parity surface, keeps f32 tiles and splits each operand into two
TF32 parts, ``hi = rna(x)`` and ``lo = rna(x - hi)``, adding ``a_lo*b_hi +
a_hi*b_lo + a_hi*b_hi`` with ``mma.sync.m16n8k8`` ("3xTF32": about 21 bits
a term, an f32 product's error; at C = 512 with one activation buffer in
place). At C = 1024 (TitaNet-L) a row of the tile is too wide for one
block: a cluster of N blocks shares a time tile of 128 rows, each block
holding C/N channels of the activation buffers; block q computes the
output columns of its channels from K chunks that it copies out of the
other blocks' shared memory (distributed shared memory), in a fixed order
from its own first chunk on: f32 with 3xTF32 ``mma.sync`` and two
activation buffers, bf16 with ``wgmma`` and one buffer in place (the
products wait in registers until every block has read it).
:data:`TC_TILES`, :data:`F32_TILES`, :data:`CLUSTER_TILES`,
:func:`tile_rows`, :func:`smem_bytes` (a block's), :func:`kernel_supports`
and :func:`kernel_design` mirror the tile geometry of the three designs;
:func:`chunk_order` the cluster design's K order.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from titanet_torch.ops.kernels import _build

MAX_SMEM = 232448
# bf16 (tensor-core kernels), by channel count: (instruction, rows RM, output
# columns a pass NC, rows a weight slab KS, ring stages NST)
# (csrc/megablock.cu::Tc* and Wg*)
TC_TILES = {128: ("mma.sync", 64, 128, 32, 3), 256: ("wgmma", 128, 256, 32, 4),
            512: ("wgmma", 64, 512, 16, 4)}
# f32, by channel count: (design, rows RM, output columns a pass NC, rows a
# weight slab KS, ring stages NST) (csrc/megablock.cu::Tf*: two activation
# buffers, or one "in place")
F32_TILES = {128: ("3xTF32", 64, 128, 32, 3), 256: ("3xTF32", 80, 256, 16, 2),
             512: ("3xTF32 in place", 64, 512, 16, 2)}


class ClusterTile(NamedTuple):
    """A tile of the cluster design (csrc/megablock.cu::Cl1024*).
    "3xTF32 mma.sync": two activation buffers, two chunk slots, ``wm`` x
    ``wn`` warps; "wgmma": one activation buffer in place, three chunk
    slots, ``wm`` x ``wn`` warpgroups of 64 rows."""

    product: str
    blocks: int  # a cluster's blocks N; a block holds C/N channels
    rows: int  # RM
    wm: int  # warps (warpgroups) over the rows
    wn: int  # over the block's C/N columns
    chunk: int  # K chunk KC, a weight slab's rows
    stages: int  # weight ring stages NST


# The cluster design, by (channel count, dtype)
CLUSTER_TILES = {(1024, torch.float32): ClusterTile("3xTF32 mma.sync", 8, 128, 4, 2, 32, 2),
                 (1024, torch.bfloat16): ClusterTile("wgmma", 4, 128, 2, 1, 64, 3)}
_SMEM_ROW_PAD = 8  # bf16 elements (csrc/mma_bf16.cuh::kPad)
_F32_A_PAD, _F32_W_PAD = 4, 8  # floats: activation and weight-slab row padding (Tf32Cfg, ClCfg)


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm in eval mode -> per-channel ``(scale', shift')``."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def _cluster(channels: int, dtype):
    return CLUSTER_TILES.get((channels, dtype))


def tile_rows(channels: int, dtype) -> int:
    """Rows RM of the largest stage output a block (or a cluster) computes;
    a tile is ``RM - 2*pad*(S-1)`` output rows."""
    cl = _cluster(channels, dtype)
    if cl is not None:
        return cl.rows
    return (TC_TILES if dtype == torch.bfloat16 else F32_TILES)[channels][1]


def kernel_design(dtype, channels: int) -> str:
    """Which of the source's kernels a dtype and width run."""
    cl = _cluster(channels, dtype)
    if cl is not None:
        return f"tensor-core, {cl.product}{' in place' if cl.product == 'wgmma' else ''}, cluster of {cl.blocks}"
    if dtype != torch.bfloat16:
        design = F32_TILES[channels][0]
        return "tensor-core, 3xTF32 mma.sync" + (", in place" if design.endswith("in place") else "")
    return f"tensor-core, {TC_TILES[channels][0]}"


def chunk_order(channels: int, dtype, rank: int) -> list:
    """First input channel of each K chunk in the order block ``rank`` of
    the cluster design multiplies them: from its own first chunk on."""
    tile = CLUSTER_TILES[channels, dtype]
    n_chunks, own = channels // tile.chunk, channels // tile.blocks // tile.chunk
    return [((j + rank * own) % n_chunks) * tile.chunk for j in range(n_chunks)]


def smem_bytes(channels: int, kernel_size: int, dtype) -> int:
    """Dynamic shared memory one block of the kernel needs."""
    pad = (kernel_size - 1) // 2
    cl = _cluster(channels, dtype)
    if cl is not None:
        # weight ring (KC x CH slabs) + chunk slots (RM x KC) + the activation
        # buffers of the block's CH channels (RM + 2*pad rows, and RM more
        # unless in place; rows padded), in dtype; pw_b, scale, shift f32.
        # mma.sync: slab and slot rows padded, two slots; wgmma: swizzled
        # panels, three slots (a slot is read until the next step's wait)
        insn, n, rm, _, _, kc, nst = cl
        ch = channels // n
        pad_a = _F32_A_PAD if dtype == torch.float32 else _SMEM_ROW_PAD
        if insn == "wgmma":
            elems = nst * kc * ch + 3 * rm * kc + (rm + 2 * pad) * (ch + pad_a)
        else:
            elems = nst * kc * (ch + 8) + 2 * rm * (kc + pad_a) + (2 * rm + 2 * pad) * (ch + pad_a)
        return elems * (4 if dtype == torch.float32 else 2) + 3 * ch * 4
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
    # depthwise buffer (RM rows; none in place) + input buffer (RM + 2*pad
    # rows), padded, + weight ring, f32; a stage's pw_b, scale and shift
    design, rm, nc, ks, nst = F32_TILES[channels]
    padded = channels + _F32_A_PAD
    buffer_rows = (rm + 2 * pad) + (0 if design.endswith("in place") else rm)
    elems = buffer_rows * padded + nst * ks * (nc + _F32_W_PAD)
    return elems * 4 + 3 * channels * 4


def kernel_supports(channels: int, kernel_size: int, n_stages: int, dtype) -> bool:
    """What the CUDA kernels take: f32 or bf16, C in 128/256/512/1024, odd
    k, and a time tile of at least 8 rows that fits shared memory (TitaNet
    S, M and L do: (C, k) = (256, 3), (512, 7), (1024, 11), S = 3)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if channels not in TC_TILES and _cluster(channels, dtype) is None:
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
    lib.titanet_megablock_cluster.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])
    lib.titanet_megablock_cluster.restype = ctypes.c_int
    lib.titanet_megablock_max_active_clusters.argtypes = [ctypes.c_int] * 3
    lib.titanet_megablock_max_active_clusters.restype = ctypes.c_int
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
    _launch(fn, (x, dw_w, dw_b, pw_w, pw_b, bn, out), (b, t, c, n_stages, kernel_size))
    fused_sub_blocks.launches += 1
    return out


def _launch(fn, tensors, sizes, extra=()) -> None:
    """``fn(*pointers, *sizes, stream, *extra)`` on the tensors' device and
    its current stream; raises with CUDA's error string where it returns
    one."""
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*(t.data_ptr() for t in tensors), *sizes, stream, *extra)
    if code != 0:
        raise RuntimeError(
            f"mega-block kernel launch failed: {_lib().titanet_megablock_error_string(code).decode()}"
        )


def cluster_launch(x, dw_w, dw_b, pw_w, pw_b, bn, kernel_size: int, cluster_blocks: int,
                   extra_smem: int = 0) -> torch.Tensor:
    """The C = 1024 cluster kernel on CUDA tensors with a cluster of
    ``cluster_blocks`` blocks and ``extra_smem`` bytes of shared memory over
    the design's: a launch that the card refuses raises with the error
    ``cudaLaunchKernelEx`` returned. Counts no launch; a cluster of another
    size than the design's computes nothing. For the card tests."""
    _check(x, dw_w, dw_b, pw_w, pw_b, bn, kernel_size)
    if x.device.type != "cuda" or x.shape[-1] != 1024:
        raise ValueError("the cluster kernel takes CUDA tensors with C = 1024")
    out = torch.empty_like(x)
    _launch(functools.partial(_lib().titanet_megablock_cluster, int(x.dtype == torch.float32)),
            (x, dw_w, dw_b, pw_w, pw_b, bn, out), (x.shape[0], x.shape[1], dw_w.shape[0], kernel_size),
            (cluster_blocks, extra_smem))
    return out


def max_active_clusters(dtype, kernel_size: int, n_stages: int = 3) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the C = 1024 design on the
    current card; raises on an error."""
    n = _lib().titanet_megablock_max_active_clusters(int(dtype == torch.float32), kernel_size, n_stages)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: {_lib().titanet_megablock_error_string(-n).decode()}")
    return n


fused_sub_blocks.launches = 0
