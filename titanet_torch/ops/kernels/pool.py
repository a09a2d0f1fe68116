"""Attentive-statistics pooling with the BN fold, forward and backward:
wrappers, plain versions, launch counts and the autograd Function.

CUDA source: ``titanet_torch/csrc/attn_pool.cu``. The forward replaces
``titanet_tpu/ops/pallas/pool.py::_fwd_impl``, the backward
``pool.py::_bwd_impl``. Per utterance, ``h [T, C] -> [mean | std]`` with
the attention ``u = tanh(y@Wa+ba)``, ``e = u@Wb+bb``, an f32 softmax over
T, and the optional fold ``y = relu(a*h + c)`` of the epilog BatchNorm. The
backward recomputes ``y``, ``u``, ``e`` and ``alpha`` from ``h`` and gives
``dh`` in h's dtype and the f32 gradients of ``a``, ``c``, ``Wa``, ``ba``,
``Wb`` and ``bb`` summed over the batch.

Two designs share the source. In bf16 with ``H == 128`` (every TitaNet)
all products run on the tensor cores. The forward is one pass over ``h``
(``pool_onepass_kernel``: tiles of 128 frames of one utterance across all
channels, ``u`` and the energies kept on the chip, an online softmax per
channel; :func:`attentive_pool_fwd_split` is its decomposition in plain
torch), which is also the backward's first stage; the backward keeps only
``u`` (f32 and bf16), ``de`` and ``dz`` (bf16) in device memory: it
recomputes the energies where it needs ``alpha``
(:func:`bwd_workspace_bytes`). f32, the parity surface, runs the FP32-core
passes. Both reduce per-block partial sums in a fixed order, so repeated
calls give the same bits.

:func:`attentive_pool_fused` is the differentiable entry point (a
``torch.autograd.Function``). :func:`attentive_pool_fwd_op` registers the
forward as the operator ``torch.ops.titanet_torch.attentive_pool_fwd``,
which a traced graph holds (an exported bf16 embedder). On a CPU tensor
:func:`attentive_pool_fwd` and :func:`attentive_pool_bwd` run their plain
versions; on a CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from titanet_torch.ops.kernels import _build

MAX_SMEM = 232448
_GRAD_NAMES = ("da", "dc", "dwa", "dba", "dwb", "dbb")
# the one-pass forward (csrc/attn_pool.cu::pool_onepass_kernel): frames of
# one utterance a tile, 64 a warpgroup; T split over at most 64 blocks an
# utterance, aiming at one block an SM of an H100 (132)
ONEPASS_ROWS = 128
ONEPASS_BLOCK_TARGET = 132
ONEPASS_MAX_SPLITS = 64


def kernel_supports(n_channels: int, hidden: int, t: int, dtype: torch.dtype) -> bool:
    """The JAX package's eligibility rule for the fused kernel (its TPU
    backend test aside): lane-aligned widths, 1 <= T <= 4096, bf16 only —
    f32 models are the parity surface and keep the plain path."""
    return (
        n_channels % 128 == 0
        and hidden % 128 == 0
        and 1 <= t <= 4096
        and dtype == torch.bfloat16
    )


def bwd_workspace_bytes(b: int, t: int, c: int, hidden: int, elem_size: int) -> int:
    """Scratch bytes of the backward: a mirror of
    ``csrc/attn_pool.cu::BwdWorkspace`` for the tests and ``chip_smoke.py``
    only. No path of the port calls it: :func:`attentive_pool_bwd` asks the
    library (``titanet_attn_pool_bwd_workspace_bytes``), and the card tests
    hold the two equal. The bf16 tensor-core route
    (``hidden == 128``) keeps u in f32 and bf16, ``de`` and ``dz`` in bf16
    and per-block partial sums: no f32 ``[B*T, C]`` array."""
    rows = b * t
    sizes = [rows * hidden * 4, 4 * b * c * 4, rows * c * elem_size]  # u, stats, de
    if elem_size == 2 and hidden == 128:
        parts = b * -(-t // 64) * 4  # (utterance, 64-frame tile, warp row)
        sizes += [rows * hidden * 2, rows * hidden * 2]  # bf16 u, bf16 dz
        sizes += [parts * hidden * 4, parts * c * 4, parts * c * 4, parts * c * 4]  # dba, dbb, da, dc
    else:
        row_blocks = -(-rows // 64)
        sizes += [rows * c * 4, rows * hidden * 4]  # f32 first term of dy, dz
        sizes += [row_blocks * hidden * 4, b * c * 4, row_blocks * c * 4, row_blocks * c * 4]
    sizes += [32 * hidden * c * 4] * 2  # split-K partials of dWb and dWa
    if elem_size == 2 and hidden == 128:
        sizes.append(2 * onepass_splits(b) * 4 * b * c * 4)  # the first stage's running states
    return sum(-(-n // 256) * 256 for n in sizes)


def onepass_splits(b: int) -> int:
    """Blocks an utterance of the one-pass forward (each walks every S-th
    128-frame tile): ``132 // B`` clipped to [1, 64], a mirror of
    ``csrc/attn_pool.cu::onepass_splits``. A split past the last tile
    holds empty states."""
    return max(1, min(ONEPASS_MAX_SPLITS, ONEPASS_BLOCK_TARGET // b))


def smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of the statistics kernel: Wb's columns for 128
    channels plus 32 frames of u, f32."""
    return (hidden * 128 + 32 * hidden) * 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("attn_pool")
    args = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.titanet_attn_pool_fwd_f32, lib.titanet_attn_pool_fwd_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    bwd_args = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.titanet_attn_pool_bwd_f32, lib.titanet_attn_pool_bwd_bf16):
        fn.argtypes = bwd_args
        fn.restype = ctypes.c_int
    for fn in (lib.titanet_attn_pool_bwd_workspace_bytes, lib.titanet_attn_pool_fwd_scratch_bytes):
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_longlong
    lib.titanet_attn_pool_error_string.argtypes = [ctypes.c_int]
    lib.titanet_attn_pool_error_string.restype = ctypes.c_char_p
    return lib


def _check(h, a, c, wa, ba, wb, bb):
    if h.dim() != 3:
        raise ValueError(f"h must be [B, T, C], got {tuple(h.shape)}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    _, t, ch = h.shape
    hid = wa.shape[1]
    shapes = {"a": (a, (ch,)), "c": (c, (ch,)), "wa": (wa, (ch, hid)),
              "ba": (ba, (hid,)), "wb": (wb, (hid, ch)), "bb": (bb, (ch,))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        want = h.dtype if name in ("wa", "wb") else torch.float32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if x.device != h.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    if t < 1:
        raise ValueError("T must be >= 1")


def attentive_pool_fwd_plain(h, a, c, wa, ba, wb, bb, eps: float = 1e-6, fold: bool = False):
    """Plain torch version of the kernel: the TPU kernel's arithmetic (the
    matmul operands in h's dtype, widened exactly to f32, f32 accumulation,
    f32 softmax and moments)."""
    dt = h.dtype
    hf = h.float()
    yf = torch.relu(hf * a + c) if fold else hf
    y = yf.to(dt).float()
    u = torch.tanh(y @ wa.float() + ba)
    e = u.to(dt).float() @ wb.float() + bb
    alpha = torch.softmax(e, dim=1)
    wy = alpha * yf
    mean = wy.sum(dim=1)
    q = (wy * yf).sum(dim=1)
    std = torch.sqrt(torch.clamp(q - mean * mean, min=eps))
    return torch.cat([mean, std], dim=-1).to(dt)


def attentive_pool_fwd_split(h, a, c, wa, ba, wb, bb, eps: float = 1e-6, fold: bool = False,
                             rows: int = ONEPASS_ROWS, splits: int | None = None):
    """Plain torch version of the one-pass kernel's decomposition, for the
    tests: ``T`` cut into tiles of ``rows`` frames, each tile into two
    halves (the kernel's two frame halves, 64 frames each); split ``s`` of ``splits``
    (default :func:`onepass_splits`) walks the tiles ``s, s + splits, ...``
    and keeps a running softmax state per half (max, sum p, sum p*yf,
    sum p*yf^2, rescaled by ``exp(m_old - m_new)``); the ``2 * splits``
    states are merged in the kernel's fixed order (split, then half).
    Operands and roundings as :func:`attentive_pool_fwd_plain`. Nothing on
    the main path calls it."""
    dt = h.dtype
    b, t, ch = h.shape
    splits = onepass_splits(b) if splits is None else splits
    hf = h.float()
    yf = torch.relu(hf * a + c) if fold else hf
    y = yf.to(dt).float()
    u = torch.tanh(y @ wa.float() + ba)
    e = u.to(dt).float() @ wb.float() + bb
    half, tiles = rows // 2, -(-t // rows)
    slots = []
    for s in range(splits):
        for w in range(2):
            m = e.new_full((b, ch), float("-inf"))
            tot, sy, syy = e.new_zeros(b, ch), e.new_zeros(b, ch), e.new_zeros(b, ch)
            for tile in range(s, tiles, splits):
                lo = tile * rows + w * half
                hi = min(lo + half, t)
                if lo >= hi:
                    continue
                es, ys = e[:, lo:hi], yf[:, lo:hi]
                mn = torch.maximum(m, es.amax(dim=1))
                r = torch.exp(m - mn)
                p = torch.exp(es - mn[:, None])
                py = p * ys
                tot = tot * r + p.sum(dim=1)
                sy = sy * r + py.sum(dim=1)
                syy = syy * r + (py * ys).sum(dim=1)
                m = mn
            slots.append((m, tot, sy, syy))
    mx = torch.stack([sl[0] for sl in slots]).amax(dim=0)
    tot_all, sy_all, syy_all = e.new_zeros(b, ch), e.new_zeros(b, ch), e.new_zeros(b, ch)
    for m, tot, sy, syy in slots:
        r = torch.exp(m - mx)  # 0 for a state that saw no frame
        tot_all = tot_all + tot * r
        sy_all = sy_all + sy * r
        syy_all = syy_all + syy * r
    mean = sy_all / tot_all
    q = syy_all / tot_all
    std = torch.sqrt(torch.clamp(q - mean * mean, min=eps))
    return torch.cat([mean, std], dim=-1).to(dt)


def attentive_pool_fwd(h, a, c, wa, ba, wb, bb, eps: float = 1e-6, fold: bool = False):
    """``h [B, T, C]`` (f32 or bf16) -> ``[B, 2C]`` in h's dtype.

    ``a``, ``c`` ``[C]`` f32 fold vectors (ignored unless ``fold``);
    ``wa [C, H]`` and ``wb [H, C]`` in h's dtype; ``ba [H]``, ``bb [C]``
    f32. All contiguous and on one device."""
    _check(h, a, c, wa, ba, wb, bb)
    if h.device.type == "cpu":
        return attentive_pool_fwd_plain(h, a, c, wa, ba, wb, bb, eps, fold)
    if h.device.type != "cuda":
        raise RuntimeError(f"no attentive-pool kernel for device {h.device}")
    b, t, ch = h.shape
    hid = wa.shape[1]
    if ch % 128 or hid % 128 or smem_bytes(hid) > MAX_SMEM:
        raise ValueError(f"kernel takes C % 128 == 0 and H in {{128, 256}}; got C={ch}, H={hid}")
    lib = _lib()
    # u [B*T, H] f32 (FP32-core route) or the running states (one-pass route)
    nbytes = lib.titanet_attn_pool_fwd_scratch_bytes(b, t, ch, hid, h.element_size())
    scratch = torch.empty(nbytes, device=h.device, dtype=torch.uint8)
    out = torch.empty(b, 2 * ch, device=h.device, dtype=h.dtype)
    fn = lib.titanet_attn_pool_fwd_f32 if h.dtype == torch.float32 else lib.titanet_attn_pool_fwd_bf16
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = fn(
            h.data_ptr(), a.data_ptr(), c.data_ptr(), wa.data_ptr(), ba.data_ptr(),
            wb.data_ptr(), bb.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            b, t, ch, hid, float(eps), int(bool(fold)), stream,
        )
    if code != 0:
        raise RuntimeError(
            f"attentive-pool kernel launch failed: "
            f"{lib.titanet_attn_pool_error_string(code).decode()}"
        )
    attentive_pool_fwd.launches += 1
    return out


attentive_pool_fwd.launches = 0


def attentive_pool_bwd_plain(h, a, c, wa, ba, wb, bb, g, eps: float = 1e-6, fold: bool = False):
    """Plain torch version of the backward kernel: the TPU kernel's
    arithmetic, including the rounding of ``u``, ``de`` and ``dz`` to h's
    dtype before the products (pool.py:151,159,164). Returns
    ``(dh, da, dc, dwa, dba, dwb, dbb)``: ``dh`` in h's dtype, the rest f32."""
    dt = h.dtype
    ch = h.shape[-1]
    hf = h.float()
    yf = torch.relu(hf * a + c) if fold else hf
    y = yf.to(dt).float()
    waf, wbf = wa.float(), wb.float()
    u = torch.tanh(y @ waf + ba)
    uc = u.to(dt).float()
    e = uc @ wbf + bb
    alpha = torch.exp(e - e.amax(dim=1, keepdim=True))
    alpha = alpha / alpha.sum(dim=1, keepdim=True)
    wy = alpha * yf
    mean = wy.sum(dim=1)
    q = (wy * yf).sum(dim=1)
    resid = q - mean * mean
    std = torch.sqrt(torch.clamp(resid, min=eps))
    gf = g.to(dt).float()
    dm, ds = gf[:, :ch], gf[:, ch:]
    dresid = torch.where(resid > eps, ds * 0.5 / std, torch.zeros_like(ds))
    dmt = (dm - 2.0 * mean * dresid)[:, None, :]
    dresid = dresid[:, None, :]
    dalpha = yf * dmt + (yf * yf) * dresid
    t_sum = (alpha * dalpha).sum(dim=1, keepdim=True)
    de = alpha * (dalpha - t_sum)
    dbb = de.sum(dim=(0, 1))
    de_c = de.to(dt).float()
    dy = alpha * (dmt + 2.0 * yf * dresid)
    du = de_c @ wbf.t()
    dwb = torch.einsum("bth,btc->hc", uc, de_c)
    dz = du * (1.0 - u * u)
    dz_c = dz.to(dt).float()
    dba = dz.sum(dim=(0, 1))
    dy = dy + dz_c @ waf.t()
    dwa = torch.einsum("btc,bth->ch", y, dz_c)
    if fold:
        dpre = torch.where(yf > 0.0, dy, torch.zeros_like(dy))
        da = (dpre * hf).sum(dim=(0, 1))
        dc = dpre.sum(dim=(0, 1))
        dh = (dpre * a).to(dt)
    else:
        da = torch.zeros_like(a)
        dc = torch.zeros_like(c)
        dh = dy.to(dt)
    return dh, da, dc, dwa, dba, dwb, dbb


def attentive_pool_bwd(h, a, c, wa, ba, wb, bb, g, eps: float = 1e-6, fold: bool = False):
    """Gradients of :func:`attentive_pool_fwd` for the output gradient
    ``g [B, 2C]`` (h's dtype): ``(dh, da, dc, dwa, dba, dwb, dbb)``, ``dh``
    in h's dtype and ``[B, T, C]``, the rest f32 in the inputs' shapes.
    Inputs as for :func:`attentive_pool_fwd`."""
    _check(h, a, c, wa, ba, wb, bb)
    b, t, ch = h.shape
    if tuple(g.shape) != (b, 2 * ch) or g.dtype != h.dtype or g.device != h.device:
        raise ValueError(f"g must be [{b}, {2 * ch}] {h.dtype} on {h.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if h.device.type == "cpu":
        return attentive_pool_bwd_plain(h, a, c, wa, ba, wb, bb, g, eps, fold)
    if h.device.type != "cuda":
        raise RuntimeError(f"no attentive-pool kernel for device {h.device}")
    hid = wa.shape[1]
    if ch % 128 or hid % 128 or smem_bytes(hid) > MAX_SMEM:
        raise ValueError(f"kernel takes C % 128 == 0 and H in {{128, 256}}; got C={ch}, H={hid}")
    lib = _lib()
    f32 = dict(device=h.device, dtype=torch.float32)
    dh = torch.empty_like(h)
    grads = {"da": torch.empty(ch, **f32), "dc": torch.empty(ch, **f32),
             "dwa": torch.empty(ch, hid, **f32), "dba": torch.empty(hid, **f32),
             "dwb": torch.empty(hid, ch, **f32), "dbb": torch.empty(ch, **f32)}
    nbytes = lib.titanet_attn_pool_bwd_workspace_bytes(b, t, ch, hid, h.element_size())
    work = torch.empty(nbytes, device=h.device, dtype=torch.uint8)
    fn = lib.titanet_attn_pool_bwd_f32 if h.dtype == torch.float32 else lib.titanet_attn_pool_bwd_bf16
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = fn(
            h.data_ptr(), a.data_ptr(), c.data_ptr(), wa.data_ptr(), ba.data_ptr(),
            wb.data_ptr(), bb.data_ptr(), g.data_ptr(), dh.data_ptr(),
            *(grads[k].data_ptr() for k in _GRAD_NAMES), work.data_ptr(),
            b, t, ch, hid, float(eps), int(bool(fold)), stream,
        )
    if code != 0:
        raise RuntimeError(
            f"attentive-pool backward kernel launch failed: "
            f"{lib.titanet_attn_pool_error_string(code).decode()}"
        )
    attentive_pool_bwd.launches += 1
    return (dh, *(grads[k] for k in _GRAD_NAMES))


attentive_pool_bwd.launches = 0


@torch.library.custom_op("titanet_torch::attentive_pool_fwd", mutates_args=())
def attentive_pool_fwd_op(
    h: torch.Tensor,
    a: torch.Tensor,
    c: torch.Tensor,
    wa: torch.Tensor,
    ba: torch.Tensor,
    wb: torch.Tensor,
    bb: torch.Tensor,
    eps: float = 1e-6,
    fold: bool = False,
) -> torch.Tensor:
    """:func:`attentive_pool_fwd` as the registered operator
    ``torch.ops.titanet_torch.attentive_pool_fwd``, so that a traced graph
    (``torch.export``, :mod:`titanet_torch.utils.export`) holds the kernel
    as one node. On a CUDA tensor it launches the kernel, on a CPU tensor it
    runs the plain version: the wrapper's own device rule. Forward only."""
    return attentive_pool_fwd(h, a, c, wa, ba, wb, bb, eps, fold)


@attentive_pool_fwd_op.register_fake
def _attentive_pool_fwd_fake(h, a, c, wa, ba, wb, bb, eps=1e-6, fold=False):
    _check(h, a, c, wa, ba, wb, bb)
    return h.new_empty((h.shape[0], 2 * h.shape[2]))


def kernel_operands(h, a, c, wa, ba, wb, bb):
    """The kernels' operands from any float dtypes: ``h`` contiguous, the
    weights ``wa``, ``wb`` in h's dtype, the vectors f32."""
    dt = h.dtype
    return (
        h.contiguous(), a.float().contiguous(), c.float().contiguous(),
        wa.to(dt).contiguous(), ba.float().contiguous(),
        wb.to(dt).contiguous(), bb.float().contiguous(),
    )


class _AttentivePool(torch.autograd.Function):
    """Forward :func:`attentive_pool_fwd`, backward :func:`attentive_pool_bwd`
    (the TPU package's ``jax.custom_vjp`` around the two Pallas kernels)."""

    @staticmethod
    def forward(ctx, h, a, c, wa, ba, wb, bb, eps, fold):
        args = kernel_operands(h, a, c, wa, ba, wb, bb)
        ctx.save_for_backward(*args)
        ctx.eps, ctx.fold = eps, fold
        ctx.grad_dtypes = tuple(x.dtype for x in (a, c, wa, ba, wb, bb))
        return attentive_pool_fwd(*args, eps, fold)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h = ctx.saved_tensors[0]
        dh, *rest = attentive_pool_bwd(
            *ctx.saved_tensors, g.to(h.dtype).contiguous(), ctx.eps, ctx.fold
        )
        return (dh, *(r.to(d) for r, d in zip(rest, ctx.grad_dtypes)), None, None)


def attentive_pool_fused(h, a, c, wa, ba, wb, bb, eps: float = 1e-6, fold: bool = False):
    """Differentiable fused attentive pooling: ``h [B, T, C] -> [B, 2C]`` in
    h's dtype. ``a``, ``c`` ``[C]`` fold vectors (ignored unless ``fold``;
    their gradients are still returned), ``wa [C, H]``, ``ba [H]``,
    ``wb [H, C]``, ``bb [C]`` in any float dtype: the weights are cast to
    h's dtype for the kernel and receive f32 gradients (in their own dtype)."""
    return _AttentivePool.apply(h, a, c, wa, ba, wb, bb, eps, fold)
