"""ECAPA-TDNN's context-dependent pooling on the card: the context
statistics kernel and the one-pass pool kernel with a first-product bias a
row and per-row lengths, each against its plain version, at the served
widths (C = 1536, H = 128, T up to the 38.4 s bucket's 3845 frames).

Imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_ctx_pool.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from titanet_torch.ops.kernels.pool import (
    attentive_pool_fwd,
    attentive_pool_fwd_plain,
    context_stats,
    context_stats_plain,
)

C, H = 1536, 128
SHAPES = [(64, 3845), (3, 151), (1, 1), (1, 3845), (5, 300)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lengths(b, t, rng, device):
    """Ragged lengths in [1, t], the first row 1 and the last t."""
    n = rng.integers(1, t + 1, b)
    n[0], n[-1] = 1, t
    return torch.as_tensor(n, dtype=torch.int32, device=device)


def _pool_args(device, b, t, seed=3):
    """An ECAPA-like input (relu'd, as the MFA layer gives it) and the
    pooling's operands, a first-product bias a row."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    h = torch.relu(r(b, t, C)).to(torch.bfloat16)
    zeros = torch.zeros(C, device=device)
    return (h, zeros, zeros, r(C, H, scale=0.03).to(torch.bfloat16), r(b, H, scale=0.5),
            r(H, C, scale=0.05).to(torch.bfloat16), r(C, scale=0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", SHAPES)
def test_context_stats_matches_plain(cuda_device, b, t):
    rng = np.random.default_rng(b * 7 + t)
    h = _pool_args(cuda_device, b, t)[0]
    for lengths in (_lengths(b, t, rng, cuda_device), None):
        before = context_stats.launches
        got = context_stats(h, lengths)
        assert context_stats.launches == before + 1
        ref = context_stats_plain(h, lengths)
        # both sum bf16 values in f32, in other orders: f32 rounding of sums
        # of up to 3845 terms of order 1 (and of E[h^2] - mean^2 for the std)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", SHAPES)
def test_rows_pool_matches_plain(cuda_device, b, t):
    args = _pool_args(cuda_device, b, t)
    lengths = _lengths(b, t, np.random.default_rng(t), cuda_device)
    before = attentive_pool_fwd.launches
    got = attentive_pool_fwd(*args, 1e-6, False, lengths).float()
    assert attentive_pool_fwd.launches == before + 1
    ref = attentive_pool_fwd_plain(*args, 1e-6, False, lengths).float()
    # bf16 outputs (2^-8 relative) and the kernel's ex2.approx softmax, as
    # the unmasked pool kernel is held in test_torch_cuda.py
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_rows_pool_ignores_frames_past_lengths(cuda_device):
    """What a row holds past its length changes no bit of its output, in
    either kernel."""
    b, t = 6, 700
    args = list(_pool_args(cuda_device, b, t))
    lengths = _lengths(b, t, np.random.default_rng(1), cuda_device)
    keep = torch.arange(t, device=cuda_device)[None, :, None] < lengths.long()[:, None, None]
    clean = torch.where(keep, args[0], torch.zeros_like(args[0]))
    noisy = torch.where(keep, args[0], torch.full_like(args[0], 37.0))
    outs = [(attentive_pool_fwd(x, *args[1:], 1e-6, False, lengths), context_stats(x, lengths))
            for x in (clean, noisy)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("b,t", [(128, 301), (64, 151), (3, 77)])
def test_titanet_route_bits_unchanged(cuda_device, b, t, fold):
    """TitaNet's unmasked route (one bias for every row, all frames) and the
    per-row route handed that bias on every row and every row's full length
    compute the same arithmetic in the same order: equal bits."""
    h, _, _, wa, ba_rows, wb, bb = _pool_args(cuda_device, b, t)
    g = torch.Generator(device="cpu").manual_seed(9)
    a = (0.5 + torch.rand(C, generator=g)).to(cuda_device)
    c = (0.2 * torch.randn(C, generator=g)).to(cuda_device)
    ba = ba_rows[0].contiguous()
    full = torch.full((b,), t, dtype=torch.int32, device=cuda_device)
    plain_route = attentive_pool_fwd(h, a, c, wa, ba, wb, bb, 1e-6, fold)
    rows_route = attentive_pool_fwd(h, a, c, wa, ba.expand(b, H).contiguous(), wb, bb, 1e-6, fold, full)
    assert torch.equal(plain_route, rows_route)


# the configuration's init_gain (perfbench/configs/ecapa_tdnn_1024.json):
# W1 and W2 at 4x and 8x the U(+-1/sqrt(fan_in)) bound, so that the
# attention is not near uniform and the context moves the answer
INIT_GAIN = {"in_linear": 4.0, "out_linear": 8.0}


@pytest.mark.cuda
def test_ecapa_pooling_takes_the_route(cuda_device, monkeypatch):
    """``ChannelContextAttentivePooling`` in bf16 on the card, W1 and W2 at
    the configuration's init gains, frames past a row's length holding
    noise: one launch of each kernel a call, no plain ``attentive_stats``,
    and the plain route's answer to its rounding (bf16 linears and
    energies there, f32 here). The two faults the check must see, the
    context left out (a zero context: the bias is b1 alone) and the context
    taken over the padded frames, each read far past that tolerance."""
    from titanet_torch.models import ecapa

    torch.manual_seed(0)
    pool = ecapa.ChannelContextAttentivePooling(C, H, dtype=torch.bfloat16).to(cuda_device).eval()
    with torch.no_grad():
        for name, gain in INIT_GAIN.items():
            getattr(pool, name).weight.mul_(gain)
    b, t = 8, 1000
    h = _pool_args(cuda_device, b, t)[0]
    lengths = _lengths(b, t, np.random.default_rng(4), cuda_device)
    mask = (torch.arange(t, device=cuda_device)[None, :] < lengths[:, None]).float()
    g = torch.Generator(device="cpu").manual_seed(5)
    h = torch.where(mask[..., None] > 0, h, (50 * torch.randn(b, t, C, generator=g)).to(h))
    calls = []
    orig = ecapa.attentive_stats
    monkeypatch.setattr(ecapa, "attentive_stats", lambda *a, **k: calls.append(1) or orig(*a, **k))
    before = (context_stats.launches, attentive_pool_fwd.launches)
    with torch.inference_mode():
        got = pool(h, mask=mask).float()
        plain = pool._plain_route(h, mask, torch.bfloat16).float()
    assert (context_stats.launches, attentive_pool_fwd.launches) == (before[0] + 1, before[1] + 1)
    assert len(calls) == 1  # the plain route's own call only
    # the plain route rounds u and the energies to bf16 (2^-8) before the
    # softmax: the answers differ by that rounding, not by more (0.016 of
    # outputs up to 3.6 in the route's plain version, f32 on the CPU)
    tol = 5e-2
    torch.testing.assert_close(got, plain, rtol=tol, atol=tol)
    stats = context_stats
    faults = {"no context": lambda x, n=None, eps=1e-6: torch.zeros(x.shape[0], 2 * x.shape[2], device=x.device),
              "context over the padded frames": lambda x, n=None, eps=1e-6: stats(x, None, eps)}
    for fault, fn in faults.items():
        monkeypatch.setattr(ecapa, "context_stats", fn)
        with torch.inference_mode():
            wrong = pool(h, mask=mask).float()
        # 1.1-1.6 in the route's plain version at these gains and this
        # noise; at the default gains the first fault read 0.004, under the
        # tolerance
        assert (wrong - plain).abs().max().item() > 10 * tol, fault
