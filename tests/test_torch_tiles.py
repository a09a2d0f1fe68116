"""Tile geometry of the port's hand-written kernels, checked without a
card: the Python mirrors of the mega-block kernel's tiles (rows, halo,
shared memory), of the pool backward's workspace, of the depthwise
backward's persistent grid (tile walk, frame groups, fixed-order partial
sums, workspace), of the frames log-mel kernel's tensor-core operands
(interleaved basis panels, padded filterbank) and of the fused log-mel
kernel's (rows over the whole batch, doubled filterbank, routing).

These tests guard the mirrors' numbers and the halo arithmetic that follows
from them; they run no line of ``csrc/megablock.cu`` or
``csrc/attn_pool.cu``. The kernels themselves (swizzles, descriptors,
fragment layouts) are held against their plain versions on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``, and the workspace mirror
against the library's own count there too.

The tiled chain below walks a time axis as ``csrc/megablock.cu`` does, with
every number taken from the mirror (tile of ``RM - 2*pad*(S-1)`` output
rows, halo ``S*pad``, zero only outside ``[0, T)``, guarded store), so a
mirror edit that breaks a tile's fit or its halo fails here.
"""

import numpy as np
import pytest
import torch

from titanet_torch.ops import frontend as tf
from titanet_torch.ops.kernels import dwconv as dk
from titanet_torch.ops.kernels import megablock as mk
from titanet_torch.ops.kernels import melspec as ms
from titanet_torch.ops.kernels import pool as pk
from tests.torch_port_helpers import fused_plain64, fused_tc_walk

DTYPES = [torch.float32, torch.bfloat16]
TITANET_SHAPES = [(256, 3, 3), (512, 7, 3), (1024, 11, 3)]  # TitaNet S, M, L


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", TITANET_SHAPES)
def test_megablock_tile_fits(dtype, shape):
    c, k, s = shape
    tile = mk.tile_rows(c, dtype) - (k - 1) * (s - 1)
    assert tile >= 8
    assert mk.smem_bytes(c, k, dtype) <= mk.MAX_SMEM == 232448
    assert mk.kernel_supports(c, k, s, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_megablock_mirror_refuses(dtype):
    assert not mk.kernel_supports(256, 4, 3, dtype)  # even k
    assert not mk.kernel_supports(192, 3, 3, dtype)  # C not in the table
    # eight stages at k = 19: a tile of 2 rows (shorter than 8) in shared memory that fits
    assert not mk.kernel_supports(1024, 19, 8, dtype) and mk.smem_bytes(1024, 19, dtype) <= mk.MAX_SMEM
    assert not mk.kernel_supports(256, 3, 0, dtype)
    for other in (torch.float16, torch.float64, torch.int8):
        assert not mk.kernel_supports(256, 3, 3, other)


@pytest.mark.parametrize("channels", sorted(mk.TC_TILES) + [1024])
def test_megablock_bf16_tiles_are_tensor_core_shaped(channels):
    """Rows in 16s (an mma tile; 64s for a warpgroup), output columns a
    pass and weight slab rows dividing C, slabs in 16s (the product's
    depth), a ring deep enough for its pipeline, 16-byte rows for cp.async,
    and for wgmma two column halves of 128 or 256. C = 1024 runs the
    cluster design: a block's C/N columns in one pass, its K chunks the
    slabs (``tests/test_torch_megablock_1024.py`` holds the rest)."""
    if channels == 1024:
        insn, n, rm, wm, wn, kc, nst = mk.CLUSTER_TILES[channels, torch.bfloat16]
        nc, ks = channels // n, kc  # a block's columns in one pass, a chunk's depth
        assert mk.kernel_design(torch.bfloat16, channels) == f"tensor-core, wgmma in place, cluster of {n}"
        assert insn == "wgmma" and rm == 64 * wm and kc == 64 and nc // wn in (128, 256)
        assert nc % 16 == 0 and channels % nc == 0 and channels % ks == 0 and nst >= 3
        assert ((nc + 8) * 2) % 16 == 0  # the activation rows, for the 16-byte copies
        return
    insn, rm, nc, ks, nst = mk.TC_TILES[channels]
    assert nc % 16 == 0 and ks % 16 == 0
    assert channels % nc == 0 and channels % ks == 0
    assert (channels * 2) % 16 == 0 and ((channels + 8) * 2) % 128 == 16
    if insn == "wgmma":
        assert rm % 64 == 0 and nc // 2 in (128, 256) and channels % 64 == 0 and nst >= 3
    else:
        assert insn == "mma.sync" and rm % 16 == 0 and nst >= 2


def _chain_args(t, c, k, s, seed):
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    bn = np.stack([rng.uniform(0.5, 1.5, (s, c)), rng.standard_normal((s, c)) * 0.3], axis=1)
    return (
        f32(rng.standard_normal((2, t, c))),
        f32(rng.standard_normal((s, k, c)) * 0.5),
        f32(rng.standard_normal((s, c)) * 0.3),
        f32(rng.standard_normal((s, c, c)) / np.sqrt(c)),
        f32(rng.standard_normal((s, c)) * 0.3),
        f32(bn),
    )


def _chain_tile_by_tile(x, dw_w, dw_b, pw_w, pw_b, bn, k, geometry):
    """The kernel's walk over time with the mirror's tile for ``geometry =
    (channels, dtype)``: per tile, load ``tile + 2*halo`` rows (zero outside
    [0, T)), run the S stages as valid convolutions on them without
    re-zeroing anything, store the rows that lie in [0, T). The resident
    rows must fit the shared memory the mirror counts for that geometry."""
    channels, dtype = geometry
    s = dw_w.shape[0]
    assert mk.kernel_supports(channels, k, s, dtype)
    rm = mk.tile_rows(channels, dtype)
    pad = (k - 1) // 2
    halo = s * pad
    tile = rm - 2 * pad * (s - 1)
    b, t, c = x.shape
    elem = torch.empty((), dtype=dtype).element_size()
    blocks = mk.CLUSTER_TILES[geometry].blocks if geometry in mk.CLUSTER_TILES else 1  # a block holds C/N channels
    resident = (tile + 2 * halo) * (channels // blocks) * elem
    assert resident < mk.smem_bytes(channels, k, dtype) <= mk.MAX_SMEM
    out = torch.empty_like(x)
    for t0 in range(0, t, tile):
        rows = torch.arange(t0 - halo, t0 + tile + halo)
        inside = (rows >= 0) & (rows < t)
        buf = torch.zeros(b, tile + 2 * halo, c, dtype=x.dtype)
        buf[:, inside] = x[:, rows[inside]]
        for i in range(s):
            n = buf.shape[1] - 2 * pad
            assert n <= rm  # the largest stage output is RM rows
            acc = torch.zeros(b, n, c)
            for j in range(k):
                acc = acc + buf[:, j : j + n] * dw_w[i, j]
            acc = (acc + dw_b[i]) @ pw_w[i]
            buf = torch.relu((acc + pw_b[i]) * bn[i, 0] + bn[i, 1])
        assert buf.shape[1] == tile
        keep = min(tile, t - t0)
        out[:, t0 : t0 + keep] = buf[:, :keep]
    return out


# the mirror's geometries (f32 and bf16, all channel counts) by their RM and
# whether a cluster of blocks shares the tile (C = 1024)
CHANNELS = (128, 256, 512, 1024)
GEOMETRIES = {}
for _dt in DTYPES:
    for _c in CHANNELS:
        GEOMETRIES.setdefault((mk.tile_rows(_c, _dt), (_c, _dt) in mk.CLUSTER_TILES), []).append((_c, _dt))


def test_tile_rows_cover_both_designs():
    assert sorted(GEOMETRIES) == [(64, False), (80, False), (128, False), (128, True)]
    assert sum(len(g) for g in GEOMETRIES.values()) == len(DTYPES) * len(CHANNELS)


@pytest.mark.parametrize("rm,cluster", [pytest.param(64, False, id="64"), pytest.param(80, False, id="80"),
                                        pytest.param(128, False, id="128"),
                                        pytest.param(128, True, id="128-cluster")])
@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("t_case", ["1", "tile-1", "tile", "tile+1", "301"])
def test_tiled_chain_equals_plain(rm, cluster, k, t_case):
    """The chain run tile by tile, with the mirror's tile of every geometry
    whose height is ``rm`` (shared by a cluster or not), equals the plain
    version in f32 at C = 128: every row, the edge rows and the rows next to
    a tile boundary included."""
    c, s = 128, 3
    tile = rm - (k - 1) * (s - 1)
    t = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "301": 301}[t_case]
    args = _chain_args(t, c, k, s, seed=k * 1000 + t)
    ref = mk.fused_sub_blocks_plain(*args, kernel_size=k)
    for geometry in GEOMETRIES[rm, cluster]:
        assert mk.tile_rows(*geometry) == rm
        got = _chain_tile_by_tile(*args, k, geometry)
        # the same sums in the same order on the same rows; the matmul may block
        # a [rows, C] product differently for different row counts
        torch.testing.assert_close(got, ref, rtol=0, atol=2e-6 * ref.abs().max().item())


def _bytes_per_btc_element(b, t, h, elem_size):
    """Workspace growth per element of a [B*T, C] array: the second
    difference over rows (64 more frames) and channels (128 more)."""
    def w(tt, cc):
        return pk.bwd_workspace_bytes(b, tt, cc, h, elem_size)

    c = 1536
    return (w(t + 64, c + 128) - w(t, c + 128) - w(t + 64, c) + w(t, c)) / (64 * b * 128)


@pytest.mark.parametrize("b,t", [(128, 301), (3, 1000), (1, 1)])
def test_pool_backward_bf16_workspace_has_no_f32_btc_array(b, t):
    """Per element of [B*T, C] the bf16 tensor-core backward stores ``de``
    in bf16 (2 bytes) and three partial-sum rows a 16-frame warp row
    (12 / 16 bytes): no 4-byte term. The FP32-core route stores ``de`` and
    the first term of ``dy`` in f32 (8 bytes) plus its partial rows."""
    assert _bytes_per_btc_element(b, t, 128, 2) == pytest.approx(2 + 12 / 16)
    assert _bytes_per_btc_element(b, t, 128, 2) < 4
    assert _bytes_per_btc_element(b, t, 128, 4) >= 8


def test_pool_backward_workspace_main_path_size():
    """TitaNet-S training batch: the bf16 route's workspace is smaller than
    the f32 route's by more than the f32 ``[B*T, C]`` array it no longer
    stores: ``de`` in bf16 and less than two more arrays of its size."""
    b, t, c, h = 128, 301, 1536, 128
    bf16, f32 = pk.bwd_workspace_bytes(b, t, c, h, 2), pk.bwd_workspace_bytes(b, t, c, h, 4)
    assert bf16 + b * t * c * 4 < f32
    assert b * t * c * 2 < bf16 < 3 * b * t * c * 2


# ------------------------------------------------ depthwise-conv backward


def _dw_bwd_walk(x, weight, dy):
    """``csrc/dw_bwd.cu`` run as its grid would, in plain torch: for every
    128-channel slice, block ``j`` of ``G`` walks the (utterance, tile)
    pairs ``j, j + G, ...``; a tile stages ``tile_frames + K - 1`` frames of
    x and dy, zero outside [0, T); dx is stored for the tile's frames; dk and
    db are summed per frame group (frame ``f`` of a tile in group ``f %
    groups``) across the walk, the groups added in order into the block's
    partial, and the ``G`` partials reduced as ``dw_reduce_kernel`` does
    (8 strided sums, then those in order)."""
    b, t, c = x.shape
    k = weight.shape[-1]
    pad = (k - 1) // 2
    es = x.element_size()
    fr, ng = dk.tile_frames(es), dk.frame_groups(es)
    tiles = -(-t // fr)
    items = b * tiles
    g_blocks = dk.grid_blocks(b, t, c, es)
    assert dk.workspace_bytes(b, t, c, k, es) == g_blocks * (k + 1) * c * 4
    assert dk.smem_bytes(k, es) <= dk.MAX_SMEM
    w = weight[:, 0, :].float()
    dx = torch.full(x.shape, float("nan"))
    part = torch.zeros(g_blocks, k + 1, c)
    walked = []
    for s in range(c // 128):
        cs = slice(128 * s, 128 * (s + 1))
        for j in range(g_blocks):
            acc = torch.zeros(ng, k + 1, 128)
            for item in range(j, items, g_blocks):
                walked.append((s, item))
                bi, ti = divmod(item, tiles)
                t0 = ti * fr
                frames = torch.arange(t0 - pad, t0 + fr + k - 1 - pad)
                inside = (frames >= 0) & (frames < t)
                xs = torch.zeros(fr + k - 1, 128, dtype=x.dtype)
                ds = torch.zeros(fr + k - 1, 128, dtype=x.dtype)
                xs[inside] = x[bi, frames[inside], cs]
                ds[inside] = dy[bi, frames[inside], cs]
                nt = min(fr, t - t0)
                out = torch.zeros(nt, 128)
                for i in range(k):
                    out = out + ds[2 * pad - i : 2 * pad - i + nt].float() * w[cs, i]
                dx[bi, t0 : t0 + nt, cs] = out.to(x.dtype).float()
                d = ds[pad : pad + nt]
                for g in range(ng):
                    rows = slice(g, nt, ng)
                    for i in range(k):
                        acc[g, i] += (xs[i : i + nt][rows] * d[rows]).float().sum(0)
                    acc[g, k] += d[rows].float().sum(0)
            total = torch.zeros(k + 1, 128)
            for g in range(ng):
                total = total + acc[g]
            part[j, :, cs] = total
    assert sorted(walked) == [(s, i) for s in range(c // 128) for i in range(items)]
    warp_sums = [part[wi::8].sum(0) for wi in range(8)]
    red = warp_sums[0]
    for ws in warp_sums[1:]:
        red = red + ws
    return dx.to(x.dtype), red[:k].T[:, None, :].contiguous(), red[k]


def _dw_inputs(b, t, c, k, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((c, 1, k)) * 0.3).astype(np.float32))
    return x, w, dy


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("c", [128, 256])
def test_dw_bwd_grid_walk_equals_plain(c, k):
    """B=3, T=37 (not a tile multiple), f32: the walk, the halo and the
    fixed-order partial sums give the plain version's gradients within 1e-6
    of each one's largest entry (only the order of the f32 sums differs)."""
    x, w, dy = _dw_inputs(3, 37, c, k, torch.float32, seed=c + k)
    got = _dw_bwd_walk(x, w, dy)
    ref = dk.dw_bwd_plain(x, w, dy)
    for name, a, r in zip(("dx", "dk", "db"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        torch.testing.assert_close(a, r, rtol=0, atol=1e-6 * r.abs().max().item(), msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dw_bwd_grid_walks_several_tiles_a_block(dtype):
    """More pairs than blocks (64 x 301 frames: 320 bf16 / 640 f32 pairs for
    264 blocks at C=128), so blocks walk two or three tiles and carry dk in
    registers across them. f32 within 1e-6 of the largest entry; bf16 dx
    equal to the plain version's and dk, db within 1e-5 (each product
    rounded to bf16 in both; the f32 sums in another order)."""
    x, w, dy = _dw_inputs(64, 301, 128, 3, dtype, seed=7)
    es = x.element_size()
    assert dk.grid_blocks(64, 301, 128, es) < 64 * -(-301 // dk.tile_frames(es))
    got = _dw_bwd_walk(x, w, dy)
    ref = dk.dw_bwd_plain(x, w, dy)
    tol = 1e-6 if dtype == torch.float32 else 1e-5
    for name, a, r in zip(("dx", "dk", "db"), got, ref):
        atol = 0 if (name == "dx" and dtype == torch.bfloat16) else tol * r.float().abs().max().item()
        torch.testing.assert_close(a.float(), r.float(), rtol=0, atol=atol, msg=name)


@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("shape", [(256, 3), (512, 7), (1024, 11), (128, 3)])
def test_dw_bwd_geometry_fits(shape, elem_size):
    """Every width the port's models use (TitaNet S / M / L) and the tests'
    C = 128: the two stages and the partials fit two blocks an SM; the grid
    keeps ~264 blocks at the main-path batch and its workspace is G x (K+1)
    x C f32, smaller than one f32 [B, T, C] array."""
    c, k = shape
    assert 2 * (dk.smem_bytes(k, elem_size) + 1024) <= 228 * 1024
    g = dk.grid_blocks(128, 301, c, elem_size)
    assert g * (c // 128) in range(264, 264 + c // 128)
    assert dk.workspace_bytes(128, 301, c, k, elem_size) == g * (k + 1) * c * 4 < 128 * 301 * c * 4
    assert dk.grid_blocks(1, 1, c, elem_size) == 1


# ------------------------------------------------------ frames log-mel


def _frames_tc_walk(frames, basis, fb, k_lo, k_hi, dtype):
    """``mel_frames_tc_kernel`` on the operands the wrapper hands it, in
    plain torch (``dtype`` for the sums): 128-frame tiles of bf16 frames,
    zero past the taps and rows; tile ``b`` walks the 128-bin panels from
    panel ``b % n_panels`` on; per panel the DFT slab by slab (32 taps),
    re and im taken from each 8-bin group's cos and sin columns (in panel
    0 bin 0's sin column is the Nyquist bin's cos), the power rounded once
    to bf16 and multiplied into the mel sums 16 bins at a time against the
    panel's filterbank rows (in panel 0 also the Nyquist bin against its
    row); then dB and the L2 norm."""
    k_lo, taps = ms.tc_taps(k_lo, k_hi)
    n_bins, n_mels = basis.shape[2], fb.shape[1]
    tpp, n_groups, n_panels, kb = ms.tc_layout(taps, n_bins)
    assert k_lo % 16 == 0 and k_lo + taps == k_hi
    panels = ms.tc_basis(basis, k_lo, k_hi)
    fbp = ms.tc_filterbank(fb)
    assert panels.shape == (n_panels, tpp, 256) and panels.dtype == torch.bfloat16
    assert fbp.shape == (kb, n_mels) and not fbp[n_bins - 1 : n_panels * 128].any()
    assert ms.tc_stages(taps, n_bins, n_mels) in ms.TC_STAGES
    panels, fbp = panels.to(dtype), fbp.to(dtype)
    n = frames.shape[0]
    out = []
    for b in range(-(-n // ms.TC_ROWS)):
        a = torch.zeros(ms.TC_ROWS, tpp, dtype=dtype)
        rows = frames[b * ms.TC_ROWS : (b + 1) * ms.TC_ROWS, k_lo:k_hi]
        a[: rows.shape[0], :taps] = rows.bfloat16().to(dtype)
        mel = torch.zeros(ms.TC_ROWS, n_mels, dtype=dtype)
        for i in range(n_panels):
            p = (b + i) % n_panels
            spec = torch.zeros(ms.TC_ROWS, 256, dtype=dtype)
            for k0 in range(0, tpp, ms.TC_SLAB):
                spec += a[:, k0 : k0 + ms.TC_SLAB] @ panels[p, k0 : k0 + ms.TC_SLAB]
            spec = spec.reshape(ms.TC_ROWS, 16, 2, 8)
            re, im = spec[:, :, 0].clone(), spec[:, :, 1].clone()
            if p == 0:
                nyq = (im[:, 0, 0] ** 2).bfloat16().to(dtype)
                im[:, 0, 0] = 0
                mel += nyq[:, None] * fbp[n_panels * 128]
            power = (re ** 2 + im ** 2).reshape(ms.TC_ROWS, 128).bfloat16().to(dtype)
            for c in range(0, min(16, n_groups - 16 * p), 2):
                mel += power[:, 8 * c : 8 * c + 16] @ fbp[128 * p + 8 * c : 128 * p + 8 * c + 16]
        db = 10 * torch.log10(mel.clamp(min=1e-10))
        out.append(db / torch.linalg.vector_norm(db, dim=-1, keepdim=True).clamp(min=1e-12))
    return torch.cat(out)[:n]


def _frames_plain64(frames, basis, fb, k_lo, k_hi):
    """log_mel_frames_plain's "default" arithmetic with f64 sums."""
    f = frames.bfloat16().double()
    re = f @ basis[0].double()
    im = f @ basis[1].double()
    p = (re * re + im * im).bfloat16().double()
    db = 10 * torch.log10((p @ fb.double()).clamp(min=1e-10))
    return db / torch.linalg.vector_norm(db, dim=-1, keepdim=True).clamp(min=1e-12)


FRAMES_GEOMETRIES = [(512, 400, 160), (512, 512, 80), (256, 200, 159)]


@pytest.mark.parametrize("n_rows", [1, 64, 453])
@pytest.mark.parametrize("geometry", FRAMES_GEOMETRIES)
def test_frames_tc_layout_equals_plain(geometry, n_rows):
    """The interleaved panels and the padded filterbank compute the plain
    version's function. With f64 sums the two agree to 1e-9 (the bf16
    roundings of frames and power fall alike). With f32 sums, the kernel's
    own, a sum in another order can put a power on the other side of a bf16
    rounding: one bf16 ulp of one bin moves the row by under 1e-3, so only
    that is held, with most entries within 1e-6."""
    n_fft, win, _ = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, precision="default")
    _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)
    frames = torch.from_numpy(np.random.default_rng(n_rows).standard_normal((n_rows, n_fft)) * 0.1)
    frames = frames.float()
    k_lo = (n_fft - win) // 2
    exact = _frames_tc_walk(frames, basis, fb, k_lo, k_lo + win, torch.float64)
    torch.testing.assert_close(exact, _frames_plain64(frames, basis, fb, k_lo, k_lo + win),
                               rtol=0, atol=1e-9)
    got = _frames_tc_walk(frames, basis, fb, k_lo, k_lo + win, torch.float32)
    ref = ms.log_mel_frames_plain(frames, basis, fb, precision="default")
    err = (got - ref).abs()
    assert err.max().item() < 1e-3 and (err > 1e-6).float().mean().item() < 0.05


@pytest.mark.parametrize("geometry", FRAMES_GEOMETRIES)
def test_frames_tc_geometry(geometry):
    """Taps padded to a 32-tap slab, bins to 8-bin groups in 128-bin panels,
    filterbank rows to the mel product's 16; every tested geometry fits one
    block's shared memory at 80 mels, the TitaNet one (408 taps from 48)
    with a 4-stage ring, the full 512 taps with 3; more taps are refused."""
    n_fft, win, _ = geometry
    n_bins = n_fft // 2 + 1
    k_lo = (n_fft - win) // 2
    k0, taps = ms.tc_taps(k_lo, k_lo + win)
    assert k0 % 16 == 0 and 0 <= k_lo - k0 < 16 and k0 + taps == k_lo + win
    tpp, n_groups, n_panels, kb = ms.tc_layout(taps, n_bins)
    assert tpp % ms.TC_SLAB == 0 and 0 <= tpp - taps < ms.TC_SLAB and tpp <= n_fft
    assert n_groups * 8 >= n_bins - 1 > (n_groups - 1) * 8  # the Nyquist bin rides in bin 0's slot
    assert n_panels * 128 >= n_groups * 8 > (n_panels - 1) * 128
    assert kb == n_panels * 128 + 16
    stages = ms.tc_stages(taps, n_bins, 80)
    assert stages in ms.TC_STAGES and ms.tc_smem_bytes(taps, n_bins, 80, stages) <= ms.MAX_SMEM
    assert ms.tc_stages(408, 257, 80) == 4 and ms.tc_stages(512, 257, 80) == 3
    assert ms.tc_stages(544, 257, 80) == 0


@pytest.mark.parametrize("geometry", FRAMES_GEOMETRIES)
def test_frames_tc_window_skip_only_drops_zero_steps(geometry):
    """With the window skip the kernel's 16-tap product steps are those of
    the full-width call minus steps whose basis rows are all zero, so both
    calls sum the same products in the same order."""
    n_fft, win, _ = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, precision="default")
    _, _, _, basis, _ = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)
    k_lo = (n_fft - win) // 2
    k0, taps = ms.tc_taps(k_lo, k_lo + win)
    full = ms.tc_basis(basis, 0, n_fft)
    skip = ms.tc_basis(basis, k0, k_lo + win)
    tpp = skip.shape[1]
    assert k0 + tpp <= n_fft and torch.equal(full[:, k0 : k0 + tpp], skip)
    outside = torch.ones(full.shape[1], dtype=torch.bool)
    outside[k0 : k0 + tpp] = False
    assert not full[:, outside].any()


def test_frames_tc_basis_interleaves_cos_and_sin():
    """Column 16 g + 8 s + j of panel p is bin 128 p + 8 g + j, cos (s = 0)
    or sin (s = 1), tap k0 + t at row t (k0 = 48 for the 400-tap window);
    bin 0's sin column, zero in the basis, carries the Nyquist bin's cos."""
    cfg = tf.FrontendConfig.from_ms(precision="default")
    _, _, _, basis, _ = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)
    panels = ms.tc_basis(basis, 48, 456)
    rng = np.random.default_rng(0)
    assert panels.shape == (2, 416, 256)
    for _ in range(200):
        p, t, g, s, j = (int(rng.integers(n)) for n in (2, 416, 16, 2, 8))
        col, b = 16 * g + 8 * s + j, 128 * p + 8 * g + j
        want = basis[s, 48 + t, b] if t < 408 else 0
        if b == 0 and s == 1:  # bin 0's sin slot: the Nyquist bin's cos
            want = basis[0, 48 + t, 256] if t < 408 else 0
        assert panels[p, t, col] == want
    assert not basis[1, :, 0].any()


# ------------------------------------------- fused log-mel, tensor cores

FUSED_GEOMETRIES = [(512, 400, 160), (512, 400, 80), (256, 200, 159)]
# five 0.5 s utterances: 255 rows (505 at hop 80), so the last 128-row tile
# is partial and holds the ends of several utterances
FUSED_LENGTHS = {"unmasked": None, "masked": [8000, 6000, 3000, 8000, 700]}


def _fused_inputs(geometry, lengths, seed=6):
    n_fft, win, hop = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop, precision="default")
    _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)
    wav = torch.from_numpy(np.random.default_rng(seed).standard_normal((5, 8000)) * 0.1).float()
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    buf, n_frames, _ = tf._framing_buffer(wav, n_fft, hop, lens)
    return buf.bfloat16().contiguous(), lens, basis, fb, n_frames


@pytest.mark.parametrize("masking", sorted(FUSED_LENGTHS))
@pytest.mark.parametrize("geometry", FUSED_GEOMETRIES)
def test_fused_tc_walk_equals_plain(geometry, masking):
    """The fused tensor-core kernel's walk computes the plain version's
    function, masked rows included. With f64 sums the two agree to 1e-9:
    the bf16 roundings of re^2 and im^2 fall alike, and the Nyquist bin's
    sin residue, which the kernel leaves out, moves nothing at that
    tolerance. With f32 sums, the kernel's own, a square summed in another
    order can land on the other side of a bf16 rounding: under 1e-3, most
    entries within 1e-6, as the frames walk."""
    _, win, hop = geometry
    buf, lens, basis, fb, n_frames = _fused_inputs(geometry, FUSED_LENGTHS[masking])
    n_rows = buf.shape[0] * n_frames
    last = (n_rows - 1) // ms.TC_ROWS * ms.TC_ROWS
    assert last < (buf.shape[0] - 1) * n_frames  # the last tile straddles utterances
    kw = dict(n_frames=n_frames, hop=hop)
    exact = fused_tc_walk(buf, lens, basis, fb, win_length=win, dtype=torch.float64, **kw)
    torch.testing.assert_close(exact, fused_plain64(buf, lens, basis, fb, **kw), rtol=0, atol=1e-9)
    got = fused_tc_walk(buf, lens, basis, fb, win_length=win, dtype=torch.float32, **kw)
    err = (got - ms.log_mel_fused_plain(buf, lens, basis, fb, **kw)).abs()
    assert err.max().item() < 1e-3 and (err > 1e-6).float().mean().item() < 0.05
    if lens is not None:
        assert not got[4, 1 + 700 // hop :].any() and got[4, 700 // hop].all()


@pytest.mark.parametrize("n_fft", [512, 256])
def test_fused_tc_filterbank_doubles_each_group(n_fft):
    """Row ``256 p + 16 g + 8 s + j`` of the doubled filterbank is bin
    ``128 p + 8 g + j``'s fb row, under its cos column (``s = 0``) and again
    under its sin column (``s = 1``): group g holds bins 8g .. 8g + 7 twice,
    FB2's layout group by group. Under bin 0's sin slot, which carries the
    Nyquist bin's cos column, sits the Nyquist bin's row; zero past the
    bins."""
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=n_fft * 25 // 32, precision="default")
    fb = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)[4]
    n_bins = n_fft // 2 + 1
    _, _, n_panels, _ = ms.tc_layout(1, n_bins)
    doubled = ms.fused_tc_filterbank(fb)
    assert doubled.shape == (n_panels * ms.FUSED_TC_FB_ROWS, 80) and doubled.dtype == torch.bfloat16
    for p in range(n_panels):
        for g in range(16):
            for s in range(2):
                for j in range(8):
                    b = 128 * p + 8 * g + j
                    want = fb[b] if b < n_bins - 1 else torch.zeros_like(fb[0])
                    if b == 0 and s == 1:
                        want = fb[n_bins - 1]
                    assert torch.equal(doubled[256 * p + 16 * g + 8 * s + j], want), (p, g, s, j)
    # the sin column of bin 0 in the basis panels is the Nyquist bin's cos
    basis = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)[3]
    assert torch.equal(ms.tc_basis(basis, 0, n_fft)[0, :n_fft, 8], basis[0, :, n_bins - 1])


@pytest.mark.parametrize("geometry", FUSED_GEOMETRIES)
def test_fused_tc_route_takes_the_card_test_geometries(geometry):
    """``fused_tc_supports`` sends the three geometries of the card tests to
    the tensor-core kernel at 80 mels and any other ``n_mels`` to
    ``logmel_kernel``; the ring depth fits shared memory, and with two
    panels a panel has at least ``stages - 1`` slabs, so its filterbank
    rows land before its last one."""
    n_fft, win, _ = geometry
    assert ms.fused_tc_supports(n_fft, win, 80)
    assert not ms.fused_tc_supports(n_fft, win, 64) and not ms.fused_tc_supports(n_fft, win, 40)
    _, taps = ms.tc_taps(*ms._window_taps(n_fft, win))
    stages = ms.fused_tc_stages(taps, n_fft // 2 + 1, 80)
    assert stages in ms.TC_STAGES and ms.fused_tc_smem_bytes(taps, 80, stages) <= ms.MAX_SMEM
    assert ms.fused_tc_stages(408, 257, 80) == 4 and ms.fused_tc_stages(512, 257, 80) == 3
    assert ms.fused_tc_stages(544, 257, 80) == 0
    assert ms.fused_tc_stages(64, 257, 80) == 3 and ms.fused_tc_stages(64, 129, 80) == 4
