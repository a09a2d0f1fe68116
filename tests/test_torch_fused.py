"""Port's fused serving variant vs the JAX package (CPU): the mega-block
kernel's plain version vs the Pallas kernel in interpret mode, row by row,
and ``titanet_apply_fused`` with the same weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_helpers import cosine, small_titanet_pair
from titanet_torch.models.fused_inference import _stack_mega_params
from titanet_torch.models.fused_inference import titanet_apply_fused as torch_apply_fused
from titanet_torch.ops.kernels import megablock as tk
from titanet_tpu.models.fused_inference import titanet_apply_fused as jax_apply_fused
from titanet_tpu.ops.pallas import megablock as jk


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _chain_inputs(seed, b=2, t=40, c=128, s=3, k=3):
    """Random taps, biases of std 0.3 and BN vectors, so the halo rows carry
    real values between the stages."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        x=f32(rng.standard_normal((b, t, c))),
        dw_w=f32(rng.standard_normal((s, k, c)) * 0.5),
        dw_b=f32(rng.standard_normal((s, c)) * 0.3),
        pw_w=f32(rng.standard_normal((s, c, c)) / np.sqrt(c)),
        pw_b=f32(rng.standard_normal((s, c)) * 0.3),
        bn=f32(np.stack([rng.uniform(0.5, 1.5, (s, c)), rng.standard_normal((s, c)) * 0.3], axis=1)),
    )


def _jax_chain(p, k, dtype=jnp.float32, block_t=512):
    out = jk.fused_sub_blocks(
        jnp.asarray(p["x"]).astype(dtype), jnp.asarray(p["dw_w"]), jnp.asarray(p["dw_b"]),
        jnp.asarray(p["pw_w"]).astype(dtype), jnp.asarray(p["pw_b"]), jnp.asarray(p["bn"]),
        kernel_size=k, block_t=block_t,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch_args(p, dtype=torch.float32):
    t = {name: torch.from_numpy(v) for name, v in p.items()}
    return (t["x"].to(dtype), t["dw_w"], t["dw_b"], t["pw_w"].to(dtype), t["pw_b"], t["bn"])


@pytest.mark.parametrize("t", [40, 53])
@pytest.mark.parametrize("k", [3, 7])
def test_fused_sub_blocks_matches_pallas_kernel_f32(k, t):
    """Row by row, the edge rows included: 1e-4 of the largest entry (the
    f32 product sums in another order)."""
    p = _chain_inputs(10 + k + t, t=t, k=k)
    ref = _jax_chain(p, k)
    out = tk.fused_sub_blocks(*_torch_args(p), kernel_size=k).numpy()
    assert out.shape == ref.shape == (2, t, 128)
    per_row = np.abs(out - ref).max(axis=(0, 2))
    assert per_row.max() <= 1e-4 * np.abs(ref).max(), per_row
    # the Pallas tile size does not change the result
    np.testing.assert_array_equal(_jax_chain(p, k, block_t=16), ref)


@pytest.mark.parametrize("t", [40, 53])
@pytest.mark.parametrize("k", [3, 7])
def test_fused_sub_blocks_matches_pallas_kernel_bf16(k, t):
    """bf16 activations and pointwise weights: both round the depthwise sum
    and each stage's output to bf16; one bf16 ulp of the largest entry."""
    p = _chain_inputs(20 + k + t, t=t, k=k)
    ref = _jax_chain(p, k, jnp.bfloat16)
    out = tk.fused_sub_blocks(*_torch_args(p, torch.bfloat16), kernel_size=k)
    assert out.dtype == torch.bfloat16
    per_row = np.abs(out.float().numpy() - ref).max(axis=(0, 2))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert per_row.max() <= ulp, (per_row, ulp)


def _zero_padded_chain(x, dw_w, dw_b, pw_w, pw_b, bn, kernel_size):
    """The chain as TitaNet's per-conv path computes it: every stage's
    input zero-padded on its own."""
    pad = (kernel_size - 1) // 2
    h = x
    for s in range(dw_w.shape[0]):
        hp = F.pad(h, (0, 0, pad, pad))
        acc = sum(hp[:, j : j + h.shape[1]] * dw_w[s, j] for j in range(kernel_size)) + dw_b[s]
        h = torch.relu((acc @ pw_w[s] + pw_b[s]) * bn[s, 0] + bn[s, 1])
    return h


@pytest.mark.parametrize("k", [3, 7])
def test_fused_chain_differs_from_zero_padded_chain_in_edge_rows_only(k):
    """The kernel evaluates the halo rows instead of re-zeroing them: its
    output differs from the per-conv zero-padded chain in exactly the first
    and last (S-1)*pad rows."""
    t, s = 40, 3
    edge = (s - 1) * (k - 1) // 2
    args = _torch_args(_chain_inputs(30 + k, t=t, k=k, s=s))
    fused = tk.fused_sub_blocks_plain(*args, kernel_size=k)
    chain = _zero_padded_chain(*args, kernel_size=k)
    per_row = (fused - chain).abs().amax(dim=(0, 2)).numpy()
    scale = chain.abs().max().item()
    assert per_row[edge : t - edge].max() <= 1e-5 * scale
    assert (per_row[:edge] > 1e-2 * scale).all() and (per_row[t - edge :] > 1e-2 * scale).all()


def test_fused_wrapper_runs_plain_on_cpu_and_checks_inputs():
    p = _chain_inputs(40)
    args = _torch_args(p)
    before = tk.fused_sub_blocks.launches
    assert torch.equal(
        tk.fused_sub_blocks(*args, kernel_size=3), tk.fused_sub_blocks_plain(*args, kernel_size=3)
    )
    assert tk.fused_sub_blocks.launches == before
    bad = list(args)
    bad[3] = bad[3].bfloat16()  # pw_w in another dtype than x
    with pytest.raises(TypeError):
        tk.fused_sub_blocks(*bad, kernel_size=3)
    with pytest.raises(ValueError):
        tk.fused_sub_blocks(*args, kernel_size=5)  # taps are [S, 3, C]
    assert tk.kernel_supports(256, 3, 3, torch.bfloat16)
    assert tk.kernel_supports(512, 7, 3, torch.float32)
    assert tk.kernel_supports(1024, 11, 3, torch.float32)
    assert not tk.kernel_supports(200, 3, 3, torch.float32)
    assert not tk.kernel_supports(256, 4, 3, torch.float32)
    assert not tk.kernel_supports(256, 3, 3, torch.float16)
    assert not tk.kernel_supports(1024, 19, 8, torch.float32)  # tile of 2 rows, shorter than 8


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(41)
    v = [rng.uniform(0.5, 2, 64).astype(np.float32) for _ in range(4)]
    ref = jk.fold_bn(*[jnp.asarray(a) for a in v])
    out = tk.fold_bn(*[torch.from_numpy(a) for a in v])
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _mel(seed, b=2, t=64):
    return np.random.default_rng(seed).standard_normal((b, t, 80)).astype(np.float32)


@pytest.mark.parametrize(
    "dtype,kw,masked",
    [
        (None, {}, False),
        (None, {"mega_block_kernel_size": 7}, True),
        (None, {"simple_pool": True}, False),
        (None, {"simple_pool": True}, True),
        (torch.bfloat16, {}, False),
        (torch.bfloat16, {}, True),
    ],
)
def test_titanet_apply_fused_matches_jax(dtype, kw, masked):
    """Same weights through both fused paths: cosine drift < 1e-5 in f32,
    < 1e-3 in bf16."""
    jmodel, variables, tmodel = small_titanet_pair(dtype, seed=7, **kw)
    x = _mel(8)
    mask = np.ones((2, 64), np.float32)
    mask[1, 40:] = 0.0
    mj = jnp.asarray(mask) if masked else None
    mt = torch.from_numpy(mask) if masked else None
    ref = np.asarray(jax_apply_fused(jmodel, variables, jnp.asarray(x), mask=mj).astype(jnp.float32))
    out = torch_apply_fused(tmodel, torch.from_numpy(x), mask=mt)
    assert out.dtype == (dtype or torch.float32) and out.shape == (2, 192)
    drift = 1.0 - cosine(out.float().numpy(), ref)
    assert drift.max() < (1e-5 if dtype is None else 1e-3), drift


def test_titanet_apply_fused_is_close_to_the_module_forward():
    """The fused path differs from TitaNet.forward only through the edge
    rows of each mega-block."""
    _, _, tmodel = small_titanet_pair(None, seed=9)
    x = torch.from_numpy(_mel(10))
    with torch.no_grad():
        ref = tmodel(x).numpy()
    out = torch_apply_fused(tmodel, x).numpy()
    assert cosine(out, ref).min() > 0.999


def test_packed_parameters_are_cached_and_follow_the_weights():
    _, _, tmodel = small_titanet_pair(None, seed=11)
    mega = tmodel.encoder.mega_block_0
    first = _stack_mega_params(mega, 3, torch.float32)
    assert all(a is b for a, b in zip(first, _stack_mega_params(mega, 3, torch.float32)))
    assert _stack_mega_params(mega, 3, torch.bfloat16)[2].dtype == torch.bfloat16
    x = torch.from_numpy(_mel(12))
    before = torch_apply_fused(tmodel, x)
    with torch.no_grad():
        mega.sub_block_1.conv.pointwise.bias.add_(0.5)
    assert _stack_mega_params(mega, 3, torch.float32)[3] is not first[3]
    assert not torch.equal(torch_apply_fused(tmodel, x), before)
