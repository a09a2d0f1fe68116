"""The port's CUDA kernels vs their plain versions, and the bf16 training
route through them, on the card.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from titanet_torch.ops import frontend as tf
from titanet_torch.ops.kernels import dwconv, megablock
from titanet_torch.ops.kernels.melspec import (
    log_mel_frames,
    log_mel_frames_plain,
    log_mel_fused,
    log_mel_fused_plain,
    log_mel_spectrogram_pallas,
)
from titanet_torch.ops.kernels.pool import (
    attentive_pool_bwd,
    attentive_pool_bwd_plain,
    attentive_pool_fwd,
    attentive_pool_fwd_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pool_args(device, dtype, b=3, t=77, c=256, h=128, seed=5):
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    return (
        f32(rng.standard_normal((b, t, c))).to(dtype),
        f32(rng.uniform(0.5, 1.5, c)),
        f32(rng.standard_normal(c) * 0.2),
        f32(rng.standard_normal((c, h)) * 0.05).to(dtype),
        f32(rng.standard_normal(h) * 0.05),
        f32(rng.standard_normal((h, c)) * 0.05).to(dtype),
        f32(rng.standard_normal(c) * 0.05),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 77, 301])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold", [False, True])
def test_pool_kernel_matches_plain(cuda_device, dtype, fold, t):
    args = _pool_args(cuda_device, dtype, t=t)
    before = attentive_pool_fwd.launches
    out = attentive_pool_fwd(*args, 1e-6, fold).float()
    assert attentive_pool_fwd.launches == before + 1
    ref = attentive_pool_fwd_plain(*args, 1e-6, fold).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("geometry", [(512, 400, 160), (512, 400, 80), (256, 200, 159)])
def test_mel_kernel_matches_plain(cuda_device, precision, geometry):
    n_fft, win, hop = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop, precision=precision)
    dtype = torch.float32 if precision == "highest" else torch.bfloat16
    wav = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 24000)) * 0.1)
    wav = wav.float().to(cuda_device)
    lengths = torch.tensor([24000, 16000, 9000], dtype=torch.int32, device=cuda_device)
    buf, n_frames, _ = tf._framing_buffer(wav, n_fft, hop, lengths)
    _, _, _, basis, fb = tf._constants(cfg, cuda_device, dtype)
    buf = buf.to(dtype).contiguous()
    out = log_mel_fused(buf, lengths, basis, fb, n_frames=n_frames, hop=hop, win_length=win)
    ref = log_mel_fused_plain(buf, lengths, basis, fb, n_frames=n_frames, hop=hop)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


# The fused kernel's bf16 tensor-core route vs its plain version: over 4x
# the 4.6e-4 that chip_smoke.py measures at B=128 x 3 s (NVIDIA H100 80GB
# HBM3, 700 W): a square summed in another order than the plain version's
# lands on the other side of a bf16 rounding.
FUSED_TC_ATOL = 2e-3


def _fused_case(device, geometry, masked, n_mels=80, seed=6):
    n_fft, win, hop = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop, n_mels=n_mels, precision="default")
    wav = torch.from_numpy(np.random.default_rng(seed).standard_normal((3, 24000)) * 0.1).float().to(device)
    lengths = torch.tensor([24000, 16000, 9000], dtype=torch.int32, device=device) if masked else None
    buf, n_frames, _ = tf._framing_buffer(wav, n_fft, hop, lengths)
    _, _, _, basis, fb = tf._constants(cfg, device, torch.bfloat16)
    return buf.bfloat16().contiguous(), lengths, basis, fb, dict(n_frames=n_frames, hop=hop)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("geometry", [(512, 400, 160), (512, 400, 80), (256, 200, 159)])
def test_fused_tc_kernel_matches_plain(cuda_device, geometry, masked):
    """bf16 at these geometries runs ``logmel_tc_kernel`` (hop 159 takes its
    2-byte loads); within FUSED_TC_ATOL of the plain version, masked rows
    zero, and two calls give identical bits."""
    buf, lengths, basis, fb, kw = _fused_case(cuda_device, geometry, masked)
    win = geometry[1]
    before = (log_mel_fused.launches, log_mel_fused.tc_launches)
    out = log_mel_fused(buf, lengths, basis, fb, win_length=win, **kw)
    again = log_mel_fused(buf, lengths, basis, fb, win_length=win, **kw)
    torch.cuda.synchronize()
    assert (log_mel_fused.launches, log_mel_fused.tc_launches) == (before[0] + 2, before[1] + 2)
    ref = log_mel_fused_plain(buf, lengths, basis, fb, **kw)
    assert torch.isfinite(out).all() and torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0, atol=FUSED_TC_ATOL)
    if masked:
        assert not out[2, 1 + 9000 // kw["hop"] :].any()


@pytest.mark.cuda
def test_fused_tc_kernel_rounds_re2_and_im2_apart(cuda_device):
    """``_fused_kernel`` rounds re^2 and im^2 to bf16 apart. Power-of-two
    samples at least n_fft apart give every frame one non-zero tap, so re
    and im are exact products and re^2, im^2 exact in f32: the kernel and
    the twice-rounded plain version round the same squares, 1e-6 apart
    (only the mel sums' order moves their last bits); rounding the power
    once lands further than 1e-5 away."""
    cfg = tf.FrontendConfig.from_ms(precision="default")
    _, _, _, basis, fb = tf._constants(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(3)
    buf = np.zeros((4, 48640), np.float32)
    spikes = buf[:, 600:-600:613].shape
    buf[:, 600:-600:613] = rng.choice([-1.0, 1.0], spikes) * 2.0 ** rng.integers(-6, 2, spikes)
    buf = torch.from_numpy(buf).bfloat16().to(cuda_device)
    before = log_mel_fused.tc_launches
    out = log_mel_fused(buf, None, basis, fb, n_frames=301, hop=160, win_length=400)
    torch.cuda.synchronize()
    assert log_mel_fused.tc_launches == before + 1
    apart = log_mel_fused_plain(buf, None, basis, fb, n_frames=301, hop=160)
    frames, b32 = buf.float().unfold(1, 512, 160)[:, :301], basis.float()
    re, im = frames @ b32[0], frames @ b32[1]
    db = 10.0 * torch.log10(torch.clamp((re * re + im * im).bfloat16().float() @ fb.float(), min=1e-10))
    once = db / torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-12)
    assert torch.isfinite(out).all()
    assert (out - apart).abs().max().item() <= 1e-6
    assert (out - once).abs().max().item() > 1e-5


@pytest.mark.cuda
def test_fused_routes_by_geometry(cuda_device):
    """The TitaNet frontend takes the tensor-core kernel; 64 mels, which it
    is not built for, take ``logmel_kernel`` (bf16 on the FP32 cores, held
    to 5e-2 as in test_mel_kernel_matches_plain)."""
    for n_mels, tc in ((80, 1), (64, 0)):
        buf, lengths, basis, fb, kw = _fused_case(cuda_device, (512, 400, 160), True, n_mels=n_mels)
        before = (log_mel_fused.launches, log_mel_fused.tc_launches)
        out = log_mel_fused(buf, lengths, basis, fb, win_length=400, **kw)
        torch.cuda.synchronize()
        counts = (log_mel_fused.launches - before[0], log_mel_fused.tc_launches - before[1])
        assert counts == (1, tc), (n_mels, counts)
        err = (out - log_mel_fused_plain(buf, lengths, basis, fb, **kw)).abs().max().item()
        assert out.shape[-1] == n_mels and err <= (FUSED_TC_ATOL if tc else 5e-2), (n_mels, err)


@pytest.mark.cuda
def test_small_bf16_embed_step_runs_both_kernels(cuda_device):
    from titanet_torch.models.titanet import TitaNet
    from titanet_torch.train.state import embed_step

    model = TitaNet(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256,
                    dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda_device).eval()
    wav = np.random.default_rng(7).standard_normal((4, 16000)).astype(np.float32) * 0.1
    lengths = np.full(4, 16000, np.int32)
    fe = tf.FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    log_mel_fused.launches = log_mel_fused.tc_launches = attentive_pool_fwd.launches = 0
    emb = embed_step(model, wav, lengths, frontend=fe, device=cuda_device).float()
    assert log_mel_fused.launches == 1 and attentive_pool_fwd.launches == 1
    assert log_mel_fused.tc_launches == 1  # the tensor-core log-mel kernel
    assert emb.shape == (4, 192) and torch.isfinite(emb).all()
    torch.testing.assert_close(torch.linalg.vector_norm(emb, dim=-1), torch.ones(4, device=cuda_device),
                               rtol=0, atol=1e-2)


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 77, 301, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold", [False, True])
def test_pool_backward_kernel_matches_plain(cuda_device, dtype, fold, t):
    """Every gradient within tol of its largest entry (f32 1e-4: sums in
    another order; bf16 2e-2: dh is bf16 and de, dz round to bf16 before the
    products). dbb is zero in exact arithmetic: both are noise below tol of
    max |dWb|. T = 1000 spans 16 frame tiles, the last one partial."""
    args = _pool_args(cuda_device, dtype, t=t)
    g = torch.from_numpy(np.random.default_rng(t).standard_normal((3, 512)).astype(np.float32))
    g = g.to(cuda_device).to(dtype)
    before = attentive_pool_bwd.launches
    got = attentive_pool_bwd(*args, g, 1e-6, fold)
    torch.cuda.synchronize()
    assert attentive_pool_bwd.launches == before + 1
    ref = attentive_pool_bwd_plain(*args, g, 1e-6, fold)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    names = ("dh", "da", "dc", "dwa", "dba", "dwb", "dbb")
    for name, a, r in zip(names, got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a).all(), name
        if name in ("da", "dc") and not fold:
            assert not a.any() and not r.any(), name
        elif name == "dbb":
            scale = ref[5].abs().max().item()
            assert a.abs().max().item() <= tol * scale and r.abs().max().item() <= tol * scale
        else:
            assert _rel_err(a, r) <= tol, (name, _rel_err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [151, 1])
@pytest.mark.parametrize("fold", [False, True])
def test_pool_kernels_at_the_conformer_shape(cuda_device, fold, t):
    """The MFA-Conformer's pooling: C = 6 x 256 = 1536, H = 128, bf16, at
    its half-rate frame counts (T' = ceil(T/2): 151 for a 3 s chunk, odd,
    a partial last 64-frame tile; 1). The forward within phase 3's 2e-2 of
    chip_smoke.py, each gradient of the backward within phase 6's 2e-2 of
    its largest entry (dbb, zero in exact arithmetic, below 2e-2 of max
    |dWb|)."""
    args = _pool_args(cuda_device, torch.bfloat16, b=4, t=t, c=1536, h=128, seed=t)
    out = attentive_pool_fwd(*args, 1e-6, fold).float()
    ref = attentive_pool_fwd_plain(*args, 1e-6, fold).float()
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    g = torch.from_numpy(np.random.default_rng(t).standard_normal((4, 3072)).astype(np.float32))
    g = g.to(cuda_device).to(torch.bfloat16)
    got = attentive_pool_bwd(*args, g, 1e-6, fold)
    torch.cuda.synchronize()
    want = attentive_pool_bwd_plain(*args, g, 1e-6, fold)
    for name, a, r in zip(("dh", "da", "dc", "dwa", "dba", "dwb", "dbb"), got, want):
        assert a.shape == r.shape and a.dtype == r.dtype and torch.isfinite(a).all(), name
        if name in ("da", "dc") and not fold:
            assert not a.any() and not r.any(), name
        elif name == "dbb":
            scale = want[5].abs().max().item()
            assert a.abs().max().item() <= 2e-2 * scale and r.abs().max().item() <= 2e-2 * scale
        else:
            assert _rel_err(a, r) <= 2e-2, (name, _rel_err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True])
def test_pool_backward_bf16_is_deterministic(cuda_device, fold):
    """Two calls on the same inputs give the same bits in every gradient:
    the partial sums are reduced in a fixed order, without float atomics."""
    args = _pool_args(cuda_device, torch.bfloat16, b=5, t=301, c=512)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 1024)).astype(np.float32))
    g = g.to(cuda_device).to(torch.bfloat16)
    first = attentive_pool_bwd(*args, g, 1e-6, fold)
    second = attentive_pool_bwd(*args, g, 1e-6, fold)
    torch.cuda.synchronize()
    for name, x, y in zip(("dh", "da", "dc", "dwa", "dba", "dwb", "dbb"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("shape", [(128, 301, 1536, 128), (3, 1000, 256, 128), (2, 77, 256, 256)])
def test_pool_backward_workspace_mirror_matches_the_library(cuda_device, shape, elem_size):
    from titanet_torch.ops.kernels import pool

    nbytes = pool._lib().titanet_attn_pool_bwd_workspace_bytes(*shape, elem_size)
    assert nbytes == pool.bwd_workspace_bytes(*shape, elem_size)


def _dw_args(device, dtype, b, t, c, k, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(device).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(device).to(dtype)
    w = torch.from_numpy((rng.standard_normal((c, 1, k)) * 0.3).astype(np.float32)).to(device)
    return x, w, dy


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 137, 4096])
@pytest.mark.parametrize("c", [128, 256, 512, 1024])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_backward_kernel_matches_plain(cuda_device, dtype, k, c, t):
    """dx, dk, db within tol of their largest entry (f32 1e-5, bf16 3e-2:
    the JAX package's tolerances for its kernel; the sums run in another
    order, and in bf16 dx is stored in bf16). T = 1 and 2 are shorter than
    the halo, 137 ends in a partial tile, 4096 is the longest the routing
    sends to the kernel."""
    x, w, dy = _dw_args(cuda_device, dtype, 2 if t == 4096 else 3, t, c, k, seed=k + c + t)
    before = dwconv.dw_bwd.launches
    got = dwconv.dw_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert dwconv.dw_bwd.launches == before + 1
    ref = dwconv.dw_bwd_plain(x, w, dy)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for name, a, r in zip(("dx", "dk", "db"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, r) <= tol, (name, _rel_err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_backward_kernel_is_deterministic(cuda_device, dtype):
    """Two calls give identical bits: each block walks a fixed list of tiles
    and the partials are added in a fixed order, without float atomics."""
    x, w, dy = _dw_args(cuda_device, dtype, 128, 301, 256, 3, seed=1)
    first = dwconv.dw_bwd(x, w, dy)
    second = dwconv.dw_bwd(x, w, dy)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dk", "db"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_dw_backward_kernel_refuses_what_the_router_does_not_send(cuda_device):
    """Built for K <= 11 and C a multiple of 128: the shapes
    ``kernel_supports`` lets through, and no others."""
    for c, k in ((128, 13), (192, 3)):
        assert not dwconv.kernel_supports(37, c, k, torch.bfloat16)
        with pytest.raises(ValueError):
            dwconv.dw_bwd(*_dw_args(cuda_device, torch.bfloat16, 2, 37, c, k, seed=0))


@pytest.mark.cuda
@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("shape", [(128, 301, 256, 3), (3, 37, 128, 7), (2, 4096, 1024, 11), (1, 1, 512, 3)])
def test_dw_backward_workspace_mirror_matches_the_library(cuda_device, shape, elem_size):
    nbytes = dwconv._lib().titanet_dw_bwd_workspace_bytes(*shape, elem_size)
    assert nbytes == dwconv.workspace_bytes(*shape, elem_size)


@pytest.mark.cuda
def test_bf16_train_mode_gives_every_parameter_a_gradient(cuda_device, monkeypatch):
    """A bf16 model on CUDA in train mode pools through the autograd
    Function: its backward launches the pool-backward kernel once, and every
    parameter gets a finite, non-zero gradient."""
    from titanet_torch.models.titanet import TitaNet

    monkeypatch.setenv("TITANET_DW_BWD", "pallas")
    model = TitaNet(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256,
                    dtype=torch.bfloat16, dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda_device).train()
    mel = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 101, 80)).astype(np.float32))
    attentive_pool_fwd.launches = attentive_pool_bwd.launches = dwconv.dw_bwd.launches = 0
    emb = model(mel.to(cuda_device))
    (emb.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert attentive_pool_fwd.launches == 1 and attentive_pool_bwd.launches == 1
    assert dwconv.dw_bwd.launches == 6
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("geometry", [(512, 400, 160), (512, 512, 80), (256, 200, 159)])
@pytest.mark.parametrize("n_rows", [1, 64, 453])
def test_mel_frames_kernel_matches_plain(cuda_device, precision, geometry, n_rows):
    """f32 operands 1e-4, bf16-rounded operands 5e-2 (a product that lands
    on the other side of a bf16 rounding moves the dB). "default" runs the
    tensor-core kernel: n_rows 1 and 453 leave a partial 128-frame tile,
    (256, 200) pads its 200 taps to 224 and its 129 bins to 17 groups."""
    n_fft, win, hop = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop, precision=precision)
    dtype = torch.float32 if precision == "highest" else torch.bfloat16
    frames = torch.from_numpy(np.random.default_rng(n_rows).standard_normal((n_rows, n_fft)) * 0.1)
    frames = frames.float().to(cuda_device)
    _, _, _, basis, fb = tf._constants(cfg, cuda_device, dtype)
    before = log_mel_frames.launches
    out = log_mel_frames(frames, basis, fb, precision=precision, win_length=win)
    torch.cuda.synchronize()
    assert log_mel_frames.launches == before + 1
    ref = log_mel_frames_plain(frames, basis, fb, precision=precision)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 if dtype == torch.float32 else 5e-2)
    # all taps (no window skip) give the same result
    full = log_mel_frames(frames, basis, fb, precision=precision)
    torch.testing.assert_close(full, out, rtol=0, atol=1e-5)


def _one_tap_frames(n, device, seed=3):
    """Frames with one non-zero tap each, of a power-of-two size, at a tap
    the TitaNet window keeps."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((n, 512), np.float32)
    frames[np.arange(n), rng.integers(56, 456, n)] = rng.choice([-1.0, 1.0], n) * 2.0 ** rng.integers(-6, 2, n)
    return torch.from_numpy(frames).to(device)


def _power_rounded_apart(frames, basis, fb):
    """The frames log-mel with re^2 and im^2 rounded to bf16 apart (the
    fused kernel's arithmetic, the frames route's before Fault 3)."""
    b32 = basis.float()
    re, im = frames.bfloat16().float() @ b32[0], frames.bfloat16().float() @ b32[1]
    p = (re * re).bfloat16().float() + (im * im).bfloat16().float()
    db = 10.0 * torch.log10(torch.clamp(p @ fb.float(), min=1e-10))
    return db / torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-12)


@pytest.mark.cuda
def test_mel_frames_kernel_rounds_the_power_once(cuda_device):
    """Fault 3: the "default" kernel rounds re^2 + im^2 to bf16 once, as
    ``_mel_kernel`` and ``log_mel_frames_plain`` do. With one non-zero tap
    of a power-of-two size a frame, re and im are exact products, re^2 and
    im^2 are exact in f32, so the kernel and the plain version round the
    same f32 power to the same bf16 whatever order the tensor cores add in:
    they agree to 1e-6 (only the mel sums' order moves their last f32 bits).
    Rounding re^2 and im^2 apart lands up to 7e-4 away on these frames; the
    kernel must be further than 1e-5 from that."""
    cfg = tf.FrontendConfig.from_ms(precision="default")
    _, _, _, basis, fb = tf._constants(cfg, cuda_device, torch.bfloat16)
    frames = _one_tap_frames(256, cuda_device)
    out = log_mel_frames(frames, basis, fb, precision="default", win_length=400)
    once = log_mel_frames_plain(frames, basis, fb, precision="default")
    apart = _power_rounded_apart(frames, basis, fb)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - once).abs().max().item() <= 1e-6
    assert (out - apart).abs().max().item() > 1e-5


@pytest.mark.cuda
def test_frames_route_matches_fused_route(cuda_device):
    wav = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 24000)) * 0.1).float().to(cuda_device)
    lengths = torch.tensor([24000, 16000, 9000], dtype=torch.int32, device=cuda_device)
    cfg = tf.FrontendConfig.from_ms()
    out, mask = log_mel_spectrogram_pallas(wav, cfg, lengths=lengths)
    ref, rmask = tf.log_mel_spectrogram(wav, cfg._replace(use_pallas_fused=True), lengths=lengths)
    assert torch.equal(mask, rmask)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def _chain_args(device, dtype, b, t, c, k, s=3, seed=11):
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    bn = np.stack([rng.uniform(0.5, 1.5, (s, c)), rng.standard_normal((s, c)) * 0.3], axis=1)
    return (
        f32(rng.standard_normal((b, t, c))).to(dtype),
        f32(rng.standard_normal((s, k, c)) * 0.5),
        f32(rng.standard_normal((s, c)) * 0.3),
        f32(rng.standard_normal((s, c, c)) / np.sqrt(c)).to(dtype),
        f32(rng.standard_normal((s, c)) * 0.3),
        f32(bn),
    )


_MEGABLOCK_SHAPES = [(2, 1, 128, 3, 3), (3, 59, 128, 7, 3), (2, 137, 256, 3, 3), (1, 61, 256, 5, 2),
                     (2, 53, 512, 7, 3), (1, 45, 1024, 11, 3), (2, 301, 256, 3, 1)]
# bf16 (the tensor-core kernel; 124-row tiles at C=256): below a tile, around
# one tile, many tiles with a partial last one
_MEGABLOCK_BF16_SHAPES = [(b, t, 256, 3, 3) for t in (1, 5, 127, 129, 1000) for b in (1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,shape",
    [(dt, sh) for dt in (torch.float32, torch.bfloat16) for sh in _MEGABLOCK_SHAPES]
    + [(torch.bfloat16, sh) for sh in _MEGABLOCK_BF16_SHAPES],
)
def test_megablock_kernel_matches_plain(cuda_device, dtype, shape):
    """Row by row, the edge rows included: f32 within 1e-4 of the largest
    entry (the product sums in another order), bf16 within one bf16 ulp of
    it (a depthwise sum on a rounding boundary)."""
    b, t, c, k, s = shape
    args = _chain_args(cuda_device, dtype, b, t, c, k, s)
    before = megablock.fused_sub_blocks.launches
    out = megablock.fused_sub_blocks(*args, kernel_size=k)
    torch.cuda.synchronize()
    assert megablock.fused_sub_blocks.launches == before + 1
    ref = megablock.fused_sub_blocks_plain(*args, kernel_size=k)
    assert out.shape == ref.shape and out.dtype == ref.dtype and torch.isfinite(out).all()
    top = ref.float().abs().max().item()
    tol = 1e-4 * top if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)
    per_row = (out.float() - ref.float()).abs().amax(dim=(0, 2))
    assert per_row.max().item() <= tol, per_row


@pytest.mark.cuda
def test_megablock_kernel_raises_on_what_it_does_not_take(cuda_device):
    args = _chain_args(cuda_device, torch.float32, 1, 20, 192, 3)
    with pytest.raises(ValueError):
        megablock.fused_sub_blocks(*args, kernel_size=3)  # C=192


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_small_fused_and_quantized_serving_run_on_the_card(cuda_device, dtype):
    from titanet_torch.models import l2_normalize
    from titanet_torch.models.fused_inference import titanet_apply_fused
    from titanet_torch.models.quantized import quantize_titanet
    from titanet_torch.models.titanet import TitaNet
    from titanet_torch.train.state import embed_step, embed_step_quantized

    model = TitaNet(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda_device).eval()
    wav = np.random.default_rng(7).standard_normal((4, 16000)).astype(np.float32) * 0.1
    lengths = np.full(4, 16000, np.int32)
    fe = tf.FrontendConfig.from_ms(precision="highest" if dtype is None else "default")
    log_mel_frames.launches = megablock.fused_sub_blocks.launches = 0
    mel, _ = log_mel_spectrogram_pallas(torch.from_numpy(wav).to(cuda_device), fe)
    emb = l2_normalize(titanet_apply_fused(model, mel)).float()
    assert log_mel_frames.launches == 1 and megablock.fused_sub_blocks.launches == 2
    ref = embed_step(model, wav, lengths, frontend=fe, device=cuda_device).float()
    cos = torch.nn.functional.cosine_similarity(emb, ref, dim=-1)
    assert emb.shape == (4, 192) and torch.isfinite(emb).all() and cos.min() > 0.99
    if dtype is None:
        q = embed_step_quantized(quantize_titanet(model), wav, lengths, frontend=fe, device=cuda_device)
        assert torch.nn.functional.cosine_similarity(q, ref, dim=-1).min() > 0.99


@pytest.mark.cuda
def test_device_prefetch_batches_equal_host_batches_under_a_concurrent_step(cuda_device):
    """Batches staged on the side stream reach the compute stream intact
    while it is busy: each staged tensor is read only after a long kernel
    on the compute stream, by which time the prefetcher has staged the next
    batches. Without ``record_stream`` the allocator could hand a batch's
    memory to a later copy before the compute stream has read it."""
    from titanet_torch.data import ChunkConfig, DataLoader, SyntheticSpeakerDataset, device_prefetch

    ds = SyntheticSpeakerDataset(n_speakers=4, utterances_per_speaker=8, min_seconds=1.0, max_seconds=2.0)
    loader = DataLoader(ds, batch_size=4, chunk=ChunkConfig(enabled=False), transport_dtype="int16",
                        prefetch=0, seed=3)
    host = list(loader)
    copies = []
    for tensors, batch in device_prefetch(loader, device=cuda_device, size=2):
        assert all(t.is_cuda for t in tensors.values())
        torch.cuda._sleep(20_000_000)  # a step's worth of work on the compute stream
        copies.append(({k: v.clone() for k, v in tensors.items()}, batch))
        del tensors
    torch.cuda.synchronize()
    assert len(copies) == len(host) == len(loader)
    for (got, batch), ref in zip(copies, host):
        for key in ("waveform", "lengths", "speaker_ids"):
            np.testing.assert_array_equal(got[key].cpu().numpy(), getattr(ref, key), err_msg=key)
            np.testing.assert_array_equal(getattr(batch, key), getattr(ref, key), err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,atol", [("highest", 1e-4), ("default", 2e-3)])
def test_speaker_embedder_requests_through_the_fused_log_mel_kernel(cuda_device, monkeypatch, precision, atol):
    """``SpeakerEmbedder`` on the fused route (the serving entry points'
    frontend): requests of 0.3, 1.2, 7 and 40 s in one call, each bucket a
    group of one row (two windows for 40 s) padded to ``batch_size`` with
    filler rows of length 1. Every log-mel launch of the call runs the
    kernel (bf16: the tensor-core kernel) and matches its plain version on
    the launch's own operands; each padded embedding equals the
    request's solo ``embed_step`` (no filler rows, no other requests)."""
    from titanet_torch.models import get_titanet
    from titanet_torch.train.extractor import SpeakerEmbedder
    from titanet_torch.train.state import embed_step

    bf16 = precision == "default"
    model = get_titanet(n_mega_blocks=3, dtype=torch.bfloat16 if bf16 else None, device=cuda_device)
    fe = tf.FrontendConfig.from_ms(precision=precision, use_pallas_fused=True)
    embedder = SpeakerEmbedder(model, fe, batch_size=4, device=cuda_device)
    rng = np.random.default_rng(11)
    reqs = [(rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32) for s in (0.3, 1.2, 7.0, 40.0)]
    record, frontend_call = [], tf._log_mel_fused

    def keep(waveform, cfg, lengths):  # what the frontend hands the kernel, and its output
        out = frontend_call(waveform, cfg, lengths)
        record.append((tf.log_mel_fused_operands(waveform.clone(), cfg, lengths.clone()), out.clone()))
        return out

    monkeypatch.setattr(tf, "_log_mel_fused", keep)
    log_mel_fused.launches = log_mel_fused.tc_launches = 0
    batched = embedder.embed(reqs)
    torch.cuda.synchronize()
    assert len(record) == log_mel_fused.launches == 4
    assert log_mel_fused.tc_launches == (4 if bf16 else 0)
    for (args, kw), out in record:
        assert (args[1][-2:] == 1).all()  # filler rows
        assert torch.equal(log_mel_fused(*args, **kw), out)  # the operands are the launch's
        ref = log_mel_fused_plain(*args, n_frames=kw["n_frames"], hop=kw["hop"])
        err = (out - ref).abs().max().item()
        assert torch.isfinite(out).all() and err <= atol, (args[0].shape, err)
    for wav, got in zip(reqs[:3], batched[:3]):
        bucket = embedder._bucket_for(len(wav))
        padded = np.zeros((1, bucket), np.float32)
        padded[0, : len(wav)] = wav
        solo = embed_step(model, padded, np.array([len(wav)], np.int32), frontend=fe, masked=True,
                          device=cuda_device).float().cpu().numpy()[0]
        cos = float(got @ solo / (np.linalg.norm(got) * np.linalg.norm(solo)))
        assert cos > (0.999 if bf16 else 1 - 1e-5), (len(wav), cos)
    assert batched.shape == (4, 192) and np.isfinite(batched).all()


@pytest.mark.cuda
def test_device_corpus_gather_on_the_card_equals_the_cpu_gather(cuda_device):
    """The device corpus uploaded in slabs through pinned memory holds the
    CPU corpus's samples, and the gathered windows (a start near the tail,
    rows cut short) equal the CPU gather bit for bit."""
    from titanet_torch.data.dataset import SyntheticSpeakerDataset
    from titanet_torch.data.device_corpus import DeviceCorpus, gather_windows

    ds = SyntheticSpeakerDataset(n_speakers=3, utterances_per_speaker=4, seed=3, min_seconds=1.0, max_seconds=2.0)
    cpu = DeviceCorpus.build(ds, 16000, device="cpu")
    gpu = DeviceCorpus.build(ds, 16000, device=cuda_device, slab_bytes=1 << 16)
    assert gpu.flat.is_cuda and gpu.flat.dtype == torch.int16
    assert torch.equal(gpu.flat.cpu(), cpu.flat)
    starts = np.array([0, int(cpu.offsets[5]) + 77, int(cpu.offsets[-1])], np.int64)
    lengths = np.array([16000, 9000, int(cpu.lengths[-1])], np.int32)
    got = gather_windows(gpu, starts, lengths, 32000)
    assert got.is_cuda and got.shape == (3, 32000)
    assert torch.equal(got.cpu(), gather_windows(cpu, starts, lengths, 32000))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_log_mel_operator_equals_the_wrapper(cuda_device, precision):
    """``torch.ops.titanet_torch.log_mel_fused`` (what an exported fused
    embedder calls) launches the same kernel as ``log_mel_fused``: equal
    bits, one launch each."""
    from titanet_torch.ops.kernels import melspec

    rng = np.random.default_rng(2)
    wav = torch.from_numpy((rng.standard_normal((4, 24000)) * 0.1).astype(np.float32)).to(cuda_device)
    lengths = torch.tensor([24000, 20000, 16000, 9000], device=cuda_device)
    cfg = tf.FrontendConfig(precision=precision, use_pallas_fused=True)
    args, kw = tf.log_mel_fused_operands(wav, cfg, lengths)
    before = log_mel_fused.launches
    direct = log_mel_fused(*args, **kw)
    via_op = torch.ops.titanet_torch.log_mel_fused(*args, **kw)
    assert melspec.log_mel_fused.launches - before == 2
    assert torch.equal(direct, via_op)


@pytest.mark.cuda
def test_exported_fused_embedder_launches_the_kernel_and_bf16_export_refuses(cuda_device):
    """An f32 model exported with the fused frontend launches the log-mel
    kernel once a call and equals ``embed_step``; a bf16 model (its pool
    kernel is reached through ctypes) refuses export on the card."""
    from titanet_torch.models import get_titanet
    from titanet_torch.train.state import embed_step
    from titanet_torch.utils.export import export_titanet_embedder, load_embedder

    gen = torch.Generator().manual_seed(0)
    model = get_titanet(n_mega_blocks=1, device=cuda_device, generator=gen).eval()
    fe = tf.FrontendConfig(use_pallas_fused=True)
    served = load_embedder(export_titanet_embedder(model, None, fe, batch_size=2, num_samples=16000))
    rng = np.random.default_rng(4)
    wav = torch.from_numpy((rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)).to(cuda_device)
    lengths = torch.tensor([16000, 11000], dtype=torch.int32, device=cuda_device)
    before = log_mel_fused.launches
    with torch.no_grad():
        out = served(wav, lengths)
    assert log_mel_fused.launches - before == 1
    ref = embed_step(model, wav, lengths, frontend=fe, device=cuda_device)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    bf16 = get_titanet(n_mega_blocks=1, dtype=torch.bfloat16, device=cuda_device, generator=gen)
    with pytest.raises(NotImplementedError, match="item 11"):
        export_titanet_embedder(bf16, None, fe, batch_size=2, num_samples=16000)
