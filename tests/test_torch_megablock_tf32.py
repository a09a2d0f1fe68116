"""The f32 mega-block kernel's arithmetic (``csrc/megablock.cu``,
``Tf32Cfg``: split TF32, "3xTF32") emulated in torch on the CPU, and the
Python mirror of its tiles.

The emulation rounds to TF32 as ``cvt.rna.tf32.f32`` does (add ``0x1000``
to the float's bits, clear the low 13), splits each operand of the pointwise
product into ``hi = rna(x)`` and ``lo = rna(x - hi)``, and adds, per k8
step, ``a_lo @ w_hi``, then ``a_hi @ w_lo``, then ``a_hi @ w_hi`` in f32
(each product of two TF32 values is exact in f32; the tensor core's order
inside a step is its own). It walks time in the mirror's tiles of
``tile_rows(C, float32)`` rows as the kernel does. Held row by row, the edge
rows included, against ``fused_sub_blocks_plain`` and against the Pallas
kernel in interpret mode, within 1e-4 of the largest entry (the card test's
and ``chip_smoke.py`` phase 10's limit). It runs no line of CUDA: the kernel
itself is held on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.ops.kernels import megablock as mk
from titanet_tpu.ops.pallas import megablock as jk


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: to nearest, ties away from zero, 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def product_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ w [K, N]`` as the kernel's k8 steps compute it."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    acc = torch.zeros(*a.shape[:-1], w.shape[1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        acc = acc + a_lo[..., ks] @ w_hi[ks]
        acc = acc + a_hi[..., ks] @ w_lo[ks]
        acc = acc + a_hi[..., ks] @ w_hi[ks]
    return acc


def product_1xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Single-pass TF32, for comparison only (not a route of the port)."""
    return rna_tf32(a) @ rna_tf32(w)


def chain_tf32_walk(x, dw_w, dw_b, pw_w, pw_b, bn, k, product=product_3xtf32):
    """The f32 kernel's walk: tiles of ``RM - 2*pad*(S-1)`` output rows,
    ``RM = tile_rows(C, float32)``, each loading ``tile + 2*halo`` rows zero
    outside ``[0, T)``; per stage the depthwise taps summed in order (f32),
    the split product, bias, folded BN and relu on every row, halo rows
    included and never re-zeroed; the rows inside ``[0, T)`` stored."""
    s = dw_w.shape[0]
    b, t, c = x.shape
    rm = mk.tile_rows(c, torch.float32)
    pad = (k - 1) // 2
    halo = s * pad
    tile = rm - 2 * pad * (s - 1)
    out = torch.empty_like(x)
    for t0 in range(0, t, tile):
        rows = torch.arange(t0 - halo, t0 + tile + halo)
        inside = (rows >= 0) & (rows < t)
        buf = torch.zeros(b, tile + 2 * halo, c)
        buf[:, inside] = x[:, rows[inside]]
        for i in range(s):
            n = buf.shape[1] - 2 * pad
            assert n <= rm
            acc = torch.zeros(b, n, c)
            for j in range(k):
                acc = acc + buf[:, j : j + n] * dw_w[i, j]
            acc = product(acc + dw_b[i], pw_w[i])
            buf = torch.relu((acc + pw_b[i]) * bn[i, 0] + bn[i, 1])
        keep = min(tile, t - t0)
        out[:, t0 : t0 + keep] = buf[:, :keep]
    return out


def _chain(t, c, k, s, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        x=f32(rng.standard_normal((2, t, c))),
        dw_w=f32(rng.standard_normal((s, k, c)) * 0.5),
        dw_b=f32(rng.standard_normal((s, c)) * 0.3),
        pw_w=f32(rng.standard_normal((s, c, c)) / np.sqrt(c)),
        pw_b=f32(rng.standard_normal((s, c)) * 0.3),
        bn=f32(np.stack([rng.uniform(0.5, 1.5, (s, c)), rng.standard_normal((s, c)) * 0.3], axis=1)),
    )


def _per_row(got, ref) -> np.ndarray:
    return np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max(axis=(0, 2))


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 3 * 2**-11, 3.14159265, -2.5e-8])
def test_rna_tf32_rounds_to_nearest_ties_away(x):
    got = rna_tf32(torch.tensor([x], dtype=torch.float32)).item()
    m, e = np.frexp(np.float32(x))  # |m| in [0.5, 1): 11 significant bits are m * 2^11
    ref = np.float32(np.sign(m) * np.floor(abs(np.float64(m)) * 2**11 + 0.5) * 2.0 ** (e - 11))
    assert got == ref
    hi, lo = split_tf32(torch.tensor([x], dtype=torch.float32))
    assert (hi + lo).item() == np.float32(x) or abs((hi + lo).item() - x) <= abs(x) * 2**-21


@pytest.mark.parametrize("t_case", ["below", "tile-1", "tile", "tile+1", "tiles"])
@pytest.mark.parametrize("k", [3, 7])
def test_3xtf32_walk_matches_plain_and_pallas(k, t_case):
    c, s = 128, 3
    tile = mk.tile_rows(c, torch.float32) - (k - 1) * (s - 1)
    t = {"below": 5, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "tiles": 3 * tile + 7}[t_case]
    p = _chain(t, c, k, s, seed=100 * k + t)
    args = [torch.from_numpy(p[n]) for n in ("x", "dw_w", "dw_b", "pw_w", "pw_b", "bn")]
    got = chain_tf32_walk(*args, k)
    plain = mk.fused_sub_blocks_plain(*args, kernel_size=k)
    pallas = np.asarray(jk.fused_sub_blocks(*(jnp.asarray(p[n]) for n in ("x", "dw_w", "dw_b", "pw_w", "pw_b", "bn")),
                                            kernel_size=k).astype(jnp.float32))
    one_pass = chain_tf32_walk(*args, k, product=product_1xtf32)
    edge = (s - 1) * (k - 1) // 2
    for name, ref in (("plain", plain.numpy()), ("pallas", pallas)):
        top = np.abs(ref).max()
        rows = _per_row(got, ref)
        e_edge = max(rows[:edge].max(), rows[-edge:].max())
        print(f"3xTF32 walk vs {name}, k={k}, T={t} (tile {tile}): max error edge rows {e_edge / top:.2e}, "
              f"all rows {rows.max() / top:.2e} of the largest entry; single-pass TF32 "
              f"{_per_row(one_pass, ref).max() / top:.2e}")
        assert got.shape == ref.shape == (2, t, c)
        assert rows.max() <= 1e-4 * top, rows
    # the split is what keeps the error of an f32 product: one TF32 pass is
    # far coarser than three
    assert _per_row(got, plain).max() * 20 < _per_row(one_pass, plain).max()


@pytest.mark.parametrize("shape", [(256, 3, 3), (512, 7, 3), (1024, 11, 3)])  # TitaNet S, M, L
def test_f32_tile_fits_and_names_its_design(shape):
    c, k, s = shape
    assert mk.smem_bytes(c, k, torch.float32) <= mk.MAX_SMEM == 227 * 1024
    assert mk.kernel_supports(c, k, s, torch.float32)
    assert mk.kernel_design(torch.float32, c).startswith("tensor-core, 3xTF32 mma.sync")
    if c == 1024:
        # not even one f32 buffer of 32 rows beside two 1024-column slabs fits
        # a block: a cluster of blocks shares the tile, each holding C/N channels
        n, rm = mk.CLUSTER_TILES[c, torch.float32].blocks, mk.CLUSTER_TILES[c, torch.float32].rows
        assert mk.kernel_design(torch.float32, c) == f"tensor-core, 3xTF32 mma.sync, cluster of {n}"
        pad = (k - 1) // 2
        assert ((32 + 2 * pad) * (c + 4) + 2 * 8 * (c + 8) + 3 * c) * 4 > mk.MAX_SMEM
    else:
        design, rm = mk.F32_TILES[c][:2]
        assert design.startswith("3xTF32")
    assert mk.tile_rows(c, torch.float32) == rm and rm - (k - 1) * (s - 1) >= 8
    assert mk.kernel_design(torch.bfloat16, c).startswith("tensor-core, ")


@pytest.mark.parametrize("channels", [c for c, v in sorted(mk.F32_TILES.items()) if v[0].startswith("3xTF32")])
def test_f32_tiles_are_mma_shaped(channels):
    """Rows in 16s (an m16n8k8 tile), slab rows in 8s (its depth), columns
    a pass and slab rows dividing C (all C in place: the output waits in
    registers until every warp has read the buffer), a ring of at least two
    stages, and rows padded so a fragment's 32 words fall into 32 banks (A:
    C + 4 floats, bank 4g + t; B: NC + 8, bank 8t + g) and start on 16
    bytes (cp.async)."""
    design, rm, nc, ks, nst = mk.F32_TILES[channels]
    assert not design.endswith("in place") or nc == channels
    assert rm % 16 == 0 and ks % 8 == 0 and nst >= 2
    assert channels % nc == 0 and channels % ks == 0 and nc % 8 == 0
    lda, ldw = channels + 4, nc + 8
    assert lda % 32 == 4 and ldw % 32 == 8 and (lda * 4) % 16 == 0 and (ldw * 4) % 16 == 0
    banks_a = {(4 * g + t) % 32 for g in range(8) for t in range(4)}
    banks_b = {(8 * t + g) % 32 for g in range(8) for t in range(4)}
    assert {(g * lda + t) % 32 for g in range(8) for t in range(4)} == banks_a == set(range(32))
    assert {(t * ldw + g) % 32 for g in range(8) for t in range(4)} == banks_b == set(range(32))
