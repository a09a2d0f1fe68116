"""The mega-block kernel at C = 1024 (TitaNet-L), checked without a card.

At C = 1024 ``csrc/megablock.cu`` runs the cluster design
(``megablock_cluster_kernel``, ``ClCfg``): a cluster of N blocks shares one
time tile of ``RM`` rows, block q holds channels ``[q*C/N, (q+1)*C/N)`` of
both activation buffers, runs the depthwise pass on them, and computes the
product's output columns of its channels from K chunks of the depthwise
output that it copies out of the owners' shared memory, in the order
:func:`~titanet_torch.ops.kernels.megablock.chunk_order` gives. Here:

- the plain version against the Pallas kernel in interpret mode at (1024,
  11), row by row;
- the design's walk in torch: tile by tile, block by block (its channel
  slice), chunk by chunk in the block's order, the f32 product as split
  TF32 (``tests/test_torch_megablock_tf32.py``'s emulation), held against
  the plain version around one tile (bf16 runs its one buffer in place:
  the same sums);
- ``titanet_apply_fused`` at TitaNet-L's widths against the JAX package's;
- the mirror: shared memory a block, the cluster, tensor-core tiles.

No line of CUDA runs here: the kernel is held against its plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 10-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_megablock_tf32 import split_tf32
from tests.torch_port_helpers import cosine, small_titanet_pair
from titanet_torch.models.fused_inference import titanet_apply_fused as torch_apply_fused
from titanet_torch.ops.kernels import megablock as mk
from titanet_tpu.models.fused_inference import titanet_apply_fused as jax_apply_fused
from titanet_tpu.ops.pallas import megablock as jk

C, K, S = 1024, 11, 3  # TitaNet-L's mega-block
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _chain(b, t, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        x=f32(rng.standard_normal((b, t, C))),
        dw_w=f32(rng.standard_normal((S, K, C)) * 0.5),
        dw_b=f32(rng.standard_normal((S, C)) * 0.3),
        pw_w=f32(rng.standard_normal((S, C, C)) / np.sqrt(C)),
        pw_b=f32(rng.standard_normal((S, C)) * 0.3),
        bn=f32(np.stack([rng.uniform(0.5, 1.5, (S, C)), rng.standard_normal((S, C)) * 0.3], axis=1)),
    )


def _torch_args(p, dtype):
    t = {name: torch.from_numpy(v) for name, v in p.items()}
    return (t["x"].to(dtype), t["dw_w"], t["dw_b"], t["pw_w"].to(dtype), t["pw_b"], t["bn"])


def _limit(ref: np.ndarray, dtype) -> float:
    """f32: 1e-4 of the largest entry; bf16: one bf16 ulp of it."""
    top = np.abs(ref).max()
    return 1e-4 * top if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_pallas_kernel_at_titanet_l(dtype):
    """Row by row, the edge rows included, at the limits of
    ``test_torch_fused.py``'s C = 128 cases."""
    p = _chain(1, 45, seed=61 if dtype == torch.float32 else 62)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jk.fused_sub_blocks(
        jnp.asarray(p["x"]).astype(jdt), jnp.asarray(p["dw_w"]), jnp.asarray(p["dw_b"]),
        jnp.asarray(p["pw_w"]).astype(jdt), jnp.asarray(p["pw_b"]), jnp.asarray(p["bn"]), kernel_size=K,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    out = mk.fused_sub_blocks(*_torch_args(p, dtype), kernel_size=K)
    assert out.dtype == dtype and out.shape == ref.shape == (1, 45, C)
    per_row = np.abs(out.float().numpy() - ref).max(axis=(0, 2))
    assert per_row.max() <= _limit(ref, dtype), per_row


def _cluster_walk(x, dw_w, dw_b, pw_w, pw_b, bn, k):
    """The cluster design run as its grid would, in torch: per tile of
    ``RM - 2*pad*(S-1)`` output rows, the input rows zero outside [0, T),
    and per stage every block's depthwise pass on its own channel slice
    (taps in order, f32, rounded to the activation type), then every
    block's product over the K chunks in its own order (f32: per k8 step
    ``a_lo @ w_hi``, ``a_hi @ w_lo``, ``a_hi @ w_hi``; bf16: a chunk's exact
    products summed in f32), bias, folded BN and relu, halo rows never
    re-zeroed."""
    dtype = x.dtype
    _, n, rm, _, _, kc, _ = mk.CLUSTER_TILES[C, dtype]
    ch = C // n
    s = dw_w.shape[0]
    pad = (k - 1) // 2
    halo = s * pad
    tile = rm - 2 * pad * (s - 1)
    b, t, _ = x.shape
    orders = [mk.chunk_order(C, dtype, q) for q in range(n)]
    out = torch.empty_like(x)
    for t0 in range(0, t, tile):
        rows = torch.arange(t0 - halo, t0 + tile + halo)
        inside = (rows >= 0) & (rows < t)
        buf = torch.zeros(b, tile + 2 * halo, C, dtype=dtype)
        buf[:, inside] = x[:, rows[inside]]
        for i in range(s):
            m = buf.shape[1] - 2 * pad
            assert m <= rm
            dw = torch.empty(b, m, C, dtype=dtype)
            for q in range(n):  # each block's depthwise pass on its channels
                cols = slice(q * ch, (q + 1) * ch)
                acc = torch.zeros(b, m, ch)
                for j in range(k):
                    acc = acc + buf[:, j : j + m, cols].float() * dw_w[i, j, cols]
                dw[..., cols] = (acc + dw_b[i, cols]).to(dtype)
            nxt = torch.empty(b, m, C, dtype=dtype)
            for q in range(n):  # each block's output columns, its chunks in its order
                cols = slice(q * ch, (q + 1) * ch)
                acc = torch.zeros(b, m, ch)
                for kk in orders[q]:
                    a, w = dw[..., kk : kk + kc].float(), pw_w[i, kk : kk + kc, cols].float()
                    if dtype == torch.float32:
                        a_hi, a_lo = split_tf32(a)
                        w_hi, w_lo = split_tf32(w)
                        for k8 in range(0, kc, 8):
                            ks = slice(k8, k8 + 8)
                            acc = acc + a_lo[..., ks] @ w_hi[ks]
                            acc = acc + a_hi[..., ks] @ w_lo[ks]
                            acc = acc + a_hi[..., ks] @ w_hi[ks]
                    else:
                        acc = acc + a @ w
                nxt[..., cols] = torch.relu((acc + pw_b[i, cols]) * bn[i, 0, cols] + bn[i, 1, cols]).to(dtype)
            buf = nxt
        assert buf.shape[1] == tile
        keep = min(tile, t - t0)
        out[:, t0 : t0 + keep] = buf[:, :keep]
    return out


@pytest.mark.parametrize("t_case", ["tile-1", "tile", "tile+1"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_walk_matches_plain(dtype, t_case):
    """Around one tile (the second tile of T = tile + 1 holds one row): the
    walk within the kernel's limits of the plain version, row by row, the
    edge rows and the rows next to the tile boundary included."""
    tile = mk.tile_rows(C, dtype) - (K - 1) * (S - 1)
    t = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}[t_case]
    p = _chain(1, t, seed=70 + t + (0 if dtype == torch.float32 else 5))
    args = _torch_args(p, dtype)
    got = _cluster_walk(*args, K)
    ref = mk.fused_sub_blocks_plain(*args, kernel_size=K).float().numpy()
    assert got.shape == ref.shape == (1, t, C) and got.dtype == dtype
    per_row = np.abs(got.float().numpy() - ref).max(axis=(0, 2))
    assert per_row.max() <= _limit(ref, dtype), per_row


@pytest.mark.parametrize("n_mega_blocks,dtype", [(1, None), (2, None), (1, torch.bfloat16)])
def test_titanet_apply_fused_matches_jax_at_titanet_l_widths(n_mega_blocks, dtype):
    """TitaNet-L's mega-block widths (hidden 1024, k = 11, epilog 1536),
    the same weights through both fused paths: cosine drift < 1e-5 in f32,
    < 1e-3 in bf16."""
    jmodel, variables, tmodel = small_titanet_pair(
        dtype, seed=80 + n_mega_blocks, n_mega_blocks=n_mega_blocks, encoder_hidden_size=1024,
        encoder_output_size=1536, mega_block_kernel_size=11,
    )
    x = np.random.default_rng(90 + n_mega_blocks).standard_normal((2, 64, 80)).astype(np.float32)
    ref = np.asarray(jax_apply_fused(jmodel, variables, jnp.asarray(x)).astype(jnp.float32))
    out = torch_apply_fused(tmodel, torch.from_numpy(x))
    assert out.dtype == (dtype or torch.float32) and out.shape == (2, 192)
    drift = 1.0 - cosine(out.float().numpy(), ref)
    assert drift.max() < (1e-5 if dtype is None else 1e-3), drift


@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_tile_fits_and_is_tensor_core_shaped(dtype):
    """A block's shared memory fits; the cluster (at most 8 blocks, the
    portable size) divides C and a block's channels divide into K chunks;
    the tile is at least 8 rows at k = 11 (108); the 16-byte copies of a
    chunk divide over the threads. f32 (``mma.sync``): every warp's part
    in 16s (an m16n8k8 tile), chunks in 16s, rows padded so a fragment's
    32 words fall into 32 banks. bf16 (``wgmma``, in place): 64-row
    warpgroups with 128 or 256 columns, one 128-byte swizzled panel a chunk
    (64 bf16), a ring deep enough for one product group in flight."""
    insn, n, rm, wm, wn, kc, nst = mk.CLUSTER_TILES[C, dtype]
    ch = C // n
    assert 2 <= n <= 8 and C % n == 0 and ch % kc == 0 and kc % 16 == 0
    assert mk.smem_bytes(C, K, dtype) <= mk.MAX_SMEM
    assert mk.kernel_supports(C, K, S, dtype) and mk.tile_rows(C, dtype) - (K - 1) * (S - 1) == 108 >= 8
    assert mk.kernel_design(dtype, C).endswith(f", cluster of {n}")
    elem = 4 if dtype == torch.float32 else 2
    pad_a = 4 if dtype == torch.float32 else 8
    assert ((ch + pad_a) * elem) % 16 == 0  # activation rows start on 16 bytes
    if dtype == torch.float32:
        assert insn == "3xTF32 mma.sync" and nst >= 2
        assert rm % (16 * wm) == 0 and ch % (16 * wn) == 0
        assert (rm * kc * elem // 16) % (32 * wm * wn) == 0
        for ld in (kc + pad_a, ch + 8):  # chunk slots, weight slabs
            assert (ld * elem) % 16 == 0
        # A words (g, t) in bank 4g + t, B words (t, g) in 8t + g
        for lda in (ch + pad_a, kc + pad_a):
            assert {(g * lda + t) % 32 for g in range(8) for t in range(4)} == set(range(32))
        assert {(t * (ch + 8) + g) % 32 for g in range(8) for t in range(4)} == set(range(32))
        # one block holding all C channels of the cluster's rows would not fit
        assert (2 * rm + 2 * (K - 1) // 2) * C * elem > mk.MAX_SMEM
    else:
        assert insn == "wgmma" and rm == 64 * wm and ch // wn in (128, 256) and nst >= 3
        assert kc * elem == 128  # a chunk is one swizzled panel
        assert (rm * kc * elem // 16) % (128 * wm * wn) == 0
        # two buffers beside this ring and three slots would not fit: hence in place
        assert mk.smem_bytes(C, K, dtype) + rm * (ch + pad_a) * elem > mk.MAX_SMEM


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_order_covers_k_once_from_the_blocks_own_chunk(dtype):
    """Every block multiplies each K chunk once, starting with its own
    first chunk; at every step the N blocks read from N distinct owners."""
    _, n, _, _, _, kc, _ = mk.CLUSTER_TILES[C, dtype]
    ch = C // n
    orders = [mk.chunk_order(C, dtype, q) for q in range(n)]
    for q, order in enumerate(orders):
        assert sorted(order) == list(range(0, C, kc)) and order[0] == q * ch
    for j in range(C // kc):
        assert len({orders[q][j] // ch for q in range(n)}) == n
