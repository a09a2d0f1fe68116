"""Depthwise conv1d backward in one pass over ``(x, dy)``: wrapper, plain
version, launch count and the autograd Function.

CUDA source: ``titanet_torch/csrc/dw_bwd.cu`` (replaces
``titanet_tpu/ops/pallas/dwconv.py::_dw_bwd_pallas``). For a depthwise
same-pad conv (stride 1, odd K) with ``out[t, c] = sum_i w[c, i] *
x[t + i - pad, c] + b[c]``:

  dx[t, c] = sum_i w[c, i] * dy[t + pad - i, c]      f32 sum, x's dtype
  dk[c, i] = sum_{b,t} dt(x[t + i - pad, c] * dy[t, c])   f32 sum
  db[c]    = sum_{b,t} dy[t, c]                        f32 sum

(``dt(.)``: the product is rounded to the input dtype before the f32 sum,
as the TPU kernel computes it.) :func:`depthwise_conv1d_fused_bwd` keeps the
library grouped conv as its forward, like the JAX package, and takes this
backward. ``SamePadConv1d`` routes to it under ``TITANET_DW_BWD=pallas``.

On a CPU tensor :func:`dw_bwd` runs :func:`dw_bwd_plain`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from titanet_torch.ops.kernels import _build

MAX_SMEM = 232448
MAX_K = 11  # the widest tap count the kernel is built for (TitaNet L; csrc/dw_bwd.cu kMaxK)
_CHANNELS = 128  # channels of a slice (csrc/dw_bwd.cu kCh)
_GRID_TARGET = 264  # blocks in all, 2 on each of the H100's 132 SMs (kGridTarget)
_GROUPS = {2: 8, 4: 4}  # frame groups of a role by element size (Geo::kGroups)


def kernel_supports(t: int, c: int, k: int, dtype: torch.dtype) -> bool:
    """The JAX package's eligibility rule (dwconv.py::kernel_supports):
    lane-aligned channels, odd K, 1 <= T <= 4096, bf16 only; and K <= 11,
    the widest the kernel is built for (every TitaNet preset's). A wider
    conv keeps the library backward under ``TITANET_DW_BWD=pallas``."""
    return (c % 128 == 0 and k % 2 == 1 and k <= MAX_K and 1 <= t <= 4096
            and dtype == torch.bfloat16)


# Python mirror of the kernel's geometry (csrc/dw_bwd.cu): the tests walk the
# persistent grid and check shared memory with it, and the card tests hold
# the workspace size against the library's own count.


def tile_frames(elem_size: int) -> int:
    """Frames of a time tile: 64 for bf16, 32 for f32 (``Geo::kFr``)."""
    return 64 if elem_size == 2 else 32


def frame_groups(elem_size: int) -> int:
    """Frame groups of each role (``Geo::kGroups``): a tile's frame ``f``
    belongs to group ``f % groups``; 8 for bf16, 4 for f32."""
    return _GROUPS[elem_size]


def grid_blocks(b: int, t: int, c: int, elem_size: int) -> int:
    """Blocks a channel slice: ``ceil(264 / slices)``, at most one per
    (utterance, time tile) pair. Block ``j`` walks the pairs ``j, j + G,
    ...``, pair ``p`` being utterance ``p // tiles``, tile ``p % tiles``."""
    slices = c // _CHANNELS
    items = b * -(-t // tile_frames(elem_size))
    return max(1, min(-(-_GRID_TARGET // slices), items))


def workspace_bytes(b: int, t: int, c: int, k: int, elem_size: int) -> int:
    """The partials workspace: ``G x (K + 1) x C`` f32."""
    return grid_blocks(b, t, c, elem_size) * (k + 1) * c * 4


def smem_bytes(k: int, elem_size: int) -> int:
    """Dynamic shared memory of a block: two stages of x and dy tiles
    (``tile_frames + K - 1`` frames by 128 channels, x's dtype), reused
    after the walk for the frame groups' partials (f32)."""
    stages = 2 * 2 * (tile_frames(elem_size) + k - 1) * _CHANNELS * elem_size
    return max(stages, frame_groups(elem_size) * (k + 1) * _CHANNELS * 4)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dw_bwd")
    for fn in (lib.titanet_dw_bwd_f32, lib.titanet_dw_bwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.titanet_dw_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.titanet_dw_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.titanet_dw_bwd_error_string.argtypes = [ctypes.c_int]
    lib.titanet_dw_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _shift(v: torch.Tensor, s: int) -> torch.Tensor:
    """``out[:, t] = v[:, t + s]`` with zero fill off the edges."""
    if s == 0:
        return v
    out = torch.zeros_like(v)
    if s > 0:
        out[:, :-s] = v[:, s:]
    else:
        out[:, -s:] = v[:, :s]
    return out


def dw_bwd_plain(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor):
    """Plain torch version of the kernel, the TPU kernel's arithmetic.
    ``x, dy [B, T, C]``, ``weight [C, 1, K]`` -> ``(dx [B, T, C] in x's
    dtype, dk [C, 1, K] f32, db [C] f32)``."""
    k = weight.shape[-1]
    pad = (k - 1) // 2
    w = weight[:, 0, :].float()
    dx = None
    for i in range(k):
        term = _shift(dy, pad - i).float() * w[:, i]
        dx = term if dx is None else dx + term
    dk = torch.stack(
        [(_shift(x, i - pad) * dy).float().sum(dim=(0, 1)) for i in range(k)], dim=-1
    )
    db = dy.float().sum(dim=(0, 1))
    return dx.to(x.dtype), dk[:, None, :], db


def dw_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor):
    """Depthwise-conv gradients; arguments and results as for
    :func:`dw_bwd_plain`. ``x`` and ``dy`` f32 or bf16 (one dtype),
    contiguous; ``weight`` any float dtype; K odd; on the card C a multiple
    of 128 and K <= 11."""
    if x.dim() != 3 or tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"x and dy must be one [B, T, C] shape, got {tuple(x.shape)}, {tuple(dy.shape)}")
    b, t, ch = x.shape
    k = weight.shape[-1]
    if tuple(weight.shape) != (ch, 1, k) or k % 2 == 0:
        raise ValueError(f"weight must be [{ch}, 1, K] with K odd, got {tuple(weight.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must be one dtype, float32 or bfloat16; got {x.dtype}, {dy.dtype}")
    if dy.device != x.device or weight.device != x.device:
        raise ValueError("all inputs must be on one device")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous")
    if x.device.type == "cpu":
        return dw_bwd_plain(x, weight, dy)
    if x.device.type != "cuda":
        raise RuntimeError(f"no depthwise-backward kernel for device {x.device}")
    if ch % _CHANNELS or k > MAX_K:
        raise ValueError(f"kernel takes C % {_CHANNELS} == 0 and K <= {MAX_K}; got C={ch}, K={k}")
    lib = _lib()
    w = weight[:, 0, :].float().contiguous()
    dx = torch.empty_like(x)
    dk = torch.empty(ch, k, device=x.device, dtype=torch.float32)
    db = torch.empty(ch, device=x.device, dtype=torch.float32)
    work = torch.empty(lib.titanet_dw_bwd_workspace_bytes(b, t, ch, k, x.element_size()),
                       device=x.device, dtype=torch.uint8)
    fn = lib.titanet_dw_bwd_f32 if x.dtype == torch.float32 else lib.titanet_dw_bwd_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(), dk.data_ptr(),
                  db.data_ptr(), work.data_ptr(), b, t, ch, k, stream)
    if code != 0:
        raise RuntimeError(
            f"depthwise-backward kernel launch failed: {lib.titanet_dw_bwd_error_string(code).decode()}"
        )
    dw_bwd.launches += 1
    return dx, dk[:, None, :], db


dw_bwd.launches = 0


class _DepthwiseConv(torch.autograd.Function):
    """Library grouped-conv forward, :func:`dw_bwd` backward (the TPU
    package's ``jax.custom_vjp`` around ``_dw_bwd_pallas``)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        from titanet_torch.ops.conv import conv1d_same

        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return conv1d_same(x, weight.to(x.dtype), bias.to(x.dtype), groups=x.shape[-1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dk, db = dw_bwd(x.contiguous(), weight, dy.to(x.dtype).contiguous())
        return dx, dk.to(weight.dtype), db.to(ctx.bias_dtype)


def depthwise_conv1d_fused_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise same-pad conv (stride 1, odd K): ``x [B, T, C]``,
    ``weight [C, 1, K]`` and ``bias [C]`` (any float dtype; cast to x's for
    the forward, gradients in their own dtype) -> ``[B, T, C]``."""
    return _DepthwiseConv.apply(x, weight, bias)
