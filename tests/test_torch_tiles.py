"""Tile geometry of the port's hand-written kernels, checked without a
card: the Python mirrors of the mega-block kernel's tiles (rows, halo,
shared memory) and of the pool backward's workspace.

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

from titanet_torch.ops.kernels import megablock as mk
from titanet_torch.ops.kernels import pool as pk

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
    assert not mk.kernel_supports(1024, 15, 3, dtype)  # tile shorter than 8 rows
    assert not mk.kernel_supports(256, 3, 0, dtype)
    for other in (torch.float16, torch.float64, torch.int8):
        assert not mk.kernel_supports(256, 3, 3, other)


@pytest.mark.parametrize("channels", sorted(mk.TC_TILES))
def test_megablock_bf16_tiles_are_tensor_core_shaped(channels):
    """Rows in 16s (an mma tile; 64s for a warpgroup), output columns a
    pass and weight slab rows dividing C, slabs in 16s (the product's
    depth), a ring deep enough for its pipeline, 16-byte rows for cp.async,
    and for wgmma two column halves of 128 or 256."""
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
    resident = (tile + 2 * halo) * channels * elem
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


# the mirror's geometries (f32 and bf16, all channel counts) by their RM
GEOMETRIES = {}
for _dt in DTYPES:
    for _c in mk.TC_TILES:
        GEOMETRIES.setdefault(mk.tile_rows(_c, _dt), []).append((_c, _dt))


def test_tile_rows_cover_both_designs():
    assert sorted(GEOMETRIES) == [32, 64, 128]
    assert sum(len(g) for g in GEOMETRIES.values()) == len(DTYPES) * len(mk.TC_TILES)


@pytest.mark.parametrize("rm", [32, 64, 128])
@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("t_case", ["1", "tile-1", "tile", "tile+1", "301"])
def test_tiled_chain_equals_plain(rm, k, t_case):
    """The chain run tile by tile, with the mirror's tile of every geometry
    whose height is ``rm``, equals the plain version in f32 at C = 128:
    every row, the edge rows and the rows next to a tile boundary included."""
    c, s = 128, 3
    tile = rm - (k - 1) * (s - 1)
    t = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "301": 301}[t_case]
    args = _chain_args(t, c, k, s, seed=k * 1000 + t)
    ref = mk.fused_sub_blocks_plain(*args, kernel_size=k)
    for geometry in GEOMETRIES[rm]:
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
