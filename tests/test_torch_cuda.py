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
    frames_kernel,
    fused_kernel,
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


ONEPASS_SHAPES = [(128, 301, 1536), (64, 151, 1536), (1, 1, 1536), (3, 63, 1536), (3, 65, 1536),
                  (2, 4096, 1536), (3, 77, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("b,t,c", ONEPASS_SHAPES)
def test_pool_onepass_forward_matches_plain(cuda_device, b, t, c, fold):
    """The bf16 forward (pool_onepass_kernel, and pool_merge_kernel where T
    is split over blocks) within phase 3's 2e-2 of the plain version and of
    its decomposition in plain torch (attentive_pool_fwd_split): TitaNet-S
    and the Conformer at 3 s, one frame, one tile less and more than 64
    frames, T = 4096 over 32 tiles, and C = 256. One launch a call; two calls
    give the same bits."""
    from titanet_torch.ops.kernels.pool import attentive_pool_fwd_split

    args = _pool_args(cuda_device, torch.bfloat16, b=b, t=t, c=c, seed=t)
    before = attentive_pool_fwd.launches
    out = attentive_pool_fwd(*args, 1e-6, fold)
    again = attentive_pool_fwd(*args, 1e-6, fold)
    torch.cuda.synchronize()
    assert attentive_pool_fwd.launches == before + 2
    assert torch.equal(out, again)
    ref = attentive_pool_fwd_plain(*args, 1e-6, fold).float()
    split = attentive_pool_fwd_split(*args, 1e-6, fold).float()
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), split, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(128, 301), (4, 151)])
def test_pool_onepass_forward_replays_in_a_cuda_graph(cuda_device, b, t):
    """Captured in a CUDA graph (the scratch of running states and the
    tensor maps taken at capture), a replay gives the eager call's bits:
    one block an utterance (B = 128) and T split over blocks with the merge
    launch (B = 4)."""
    args = _pool_args(cuda_device, torch.bfloat16, b=b, t=t, c=1536, seed=b)
    eager = attentive_pool_fwd(*args, 1e-6, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        attentive_pool_fwd(*args, 1e-6, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = attentive_pool_fwd(*args, 1e-6, True)
    before = attentive_pool_fwd.launches
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert attentive_pool_fwd.launches == before  # a replay runs no wrapper
    assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [128, 4, 1])
def test_pool_forward_scratch_holds_the_running_states(cuda_device, b):
    """The bf16 forward's scratch is the one-pass kernel's running states,
    2 S x 4 x B x C floats (S = onepass_splits(B)); the f32 route keeps u."""
    from titanet_torch.ops.kernels import pool

    lib = pool._lib()
    assert lib.titanet_attn_pool_fwd_scratch_bytes(b, 301, 1536, 128, 2) == \
        2 * pool.onepass_splits(b) * 4 * b * 1536 * 4
    assert lib.titanet_attn_pool_fwd_scratch_bytes(b, 301, 1536, 128, 4) == b * 301 * 128 * 4


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
    kernel = fused_kernel(dtype, n_fft, win, hop, 80)
    if geometry == (512, 400, 160) and dtype == torch.float32:
        assert kernel == "logmel_dmma_kernel"  # TitaNet's frontend: the f64 tensor-core DFT
    before = (log_mel_fused.launches, log_mel_fused.dmma_launches)
    out = log_mel_fused(buf, lengths, basis, fb, n_frames=n_frames, hop=hop, win_length=win)
    assert (log_mel_fused.launches - before[0], log_mel_fused.dmma_launches - before[1]) == (
        1, int(kernel == "logmel_dmma_kernel"))
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


def _tones_with_silence(seed, b, t, lengths, floor=1e-3):
    """Tones of a few frequencies and levels over a noise floor of std
    ``floor``, silent (exact zeros) in two stretches of each row, zero past
    each row's length (the input of tests/test_torch_logmel_tf32.py)."""
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 16000.0
    wav = np.zeros((b, t), np.float32)
    for i in range(b):
        for _ in range(3):
            wav[i] += rng.uniform(0.05, 0.5) * np.sin(2 * np.pi * rng.uniform(80, 7000) * n + rng.uniform(0, 6))
        wav[i] += rng.standard_normal(t) * floor
        for _ in range(2):
            start = rng.integers(0, t - 4000)
            wav[i, start : start + rng.integers(1500, 4000)] = 0.0
        wav[i, lengths[i] :] = 0.0
    return wav


@pytest.mark.cuda
def test_f32_routes_hold_silent_stretches(cuda_device):
    """Tones with silent stretches and a ragged zero tail, TitaNet's
    frontend: both f32 routes run the f64 tensor-core kernels and stay
    within 1e-4 of their plain versions, where one TF32 pass on the DFT
    lands 6e-2 away (tests/test_torch_logmel_tf32.py emulates both); masked
    rows zero."""
    lengths = [32000, 25000, 17123]
    wav = torch.from_numpy(_tones_with_silence(4, 3, 32000, lengths)).to(cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    cfg = tf.FrontendConfig.from_ms()
    _, _, _, basis, fb = tf._constants(cfg, cuda_device, torch.float32)
    buf, n_frames, _ = tf._framing_buffer(wav, 512, 160, lens)
    buf = buf.contiguous()
    before = (log_mel_fused.dmma_launches, log_mel_frames.dmma_launches)
    out = log_mel_fused(buf, lens, basis, fb, n_frames=n_frames, hop=160, win_length=400)
    frames = tf.frame_signal(wav, 512, 160, lengths=lens).reshape(-1, 512).contiguous()
    fout = log_mel_frames(frames, basis, fb, precision="highest", win_length=400)
    torch.cuda.synchronize()
    assert (log_mel_fused.dmma_launches - before[0], log_mel_frames.dmma_launches - before[1]) == (1, 1)
    ref = log_mel_fused_plain(buf, lens, basis, fb, n_frames=n_frames, hop=160)
    fref = log_mel_frames_plain(frames, basis, fb, precision="highest")
    assert torch.isfinite(out).all() and torch.isfinite(fout).all()
    assert (out - ref).abs().max().item() <= 1e-4
    assert (fout - fref).abs().max().item() <= 1e-4
    assert not out[2, 1 + lengths[2] // 160 :].any()


def _log_mel_f64(frames, basis, fb):
    """The normalized log-mel of ``frames [..., n_fft]`` in f64 throughout."""
    b64 = basis.double()
    f = frames.double()
    re, im = f @ b64[0], f @ b64[1]
    db = 10.0 * torch.log10(((re * re + im * im) @ fb.double()).clamp(min=1e-10))
    return db / torch.linalg.vector_norm(db, dim=-1, keepdim=True).clamp(min=1e-12)


@pytest.mark.cuda
def test_f32_routes_are_exact_on_pure_tones(cuda_device):
    """Pure tones (no noise floor) with digital silence and a ragged zero
    tail, TitaNet's frontend. There the mel bands between the tones sit 130
    dB below the loudest, and f32's own rounding moves the plain versions
    past 1e-4 from the f64 result (1.9e-4 in tests/test_torch_logmel_tf32.py's
    emulation): the f64 tensor-core DFT holds both routes within 1e-6 of the
    f64 result, so they depart from the plain versions by what the plain
    versions' own rounding puts there, and no further."""
    lengths = [32000, 25000, 17123]
    wav = torch.from_numpy(_tones_with_silence(4, 3, 32000, lengths, floor=0.0)).to(cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    cfg = tf.FrontendConfig.from_ms()
    _, _, _, basis, fb = tf._constants(cfg, cuda_device, torch.float32)
    buf, n_frames, _ = tf._framing_buffer(wav, 512, 160, lens)
    buf = buf.contiguous()
    frames = tf.frame_signal(wav, 512, 160, lengths=lens).reshape(-1, 512).contiguous()
    before = (log_mel_fused.dmma_launches, log_mel_frames.dmma_launches)
    out = log_mel_fused(buf, lens, basis, fb, n_frames=n_frames, hop=160, win_length=400)
    fout = log_mel_frames(frames, basis, fb, precision="highest", win_length=400)
    torch.cuda.synchronize()
    assert (log_mel_fused.dmma_launches - before[0], log_mel_frames.dmma_launches - before[1]) == (1, 1)
    mask = (torch.arange(n_frames, device=cuda_device)[None, :] < 1 + lens.long()[:, None] // 160)[..., None]
    exact = _log_mel_f64(buf.unfold(1, 512, 160)[:, :n_frames], basis, fb) * mask
    fexact = _log_mel_f64(frames, basis, fb)
    plain = log_mel_fused_plain(buf, lens, basis, fb, n_frames=n_frames, hop=160)
    fplain = log_mel_frames_plain(frames, basis, fb, precision="highest")
    e_fused, e_frames = (out.double() - exact).abs().max().item(), (fout.double() - fexact).abs().max().item()
    e_plain, e_fplain = (plain.double() - exact).abs().max().item(), (fplain.double() - fexact).abs().max().item()
    assert e_fused <= 1e-6 and e_frames <= 1e-6, (e_fused, e_frames)
    assert e_plain > 1e-4, e_plain  # the case where the kernels and the plain versions part
    assert (out - plain).abs().max().item() <= e_plain + e_fused
    assert (fout - fplain).abs().max().item() <= e_fplain + e_frames
    assert not out[2, 1 + lengths[2] // 160 :].any()


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(512, 400, 160), (512, 400, 80), (256, 200, 159)])
def test_f32_routes_give_equal_bits(cuda_device, geometry):
    """The fused and frames f32 routes run one device function on the same
    f32 operands: on the same waveforms (no mask) their outputs are equal to
    the bit, and two calls of each give equal bits."""
    n_fft, win, hop = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    wav = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 24000)) * 0.1).float().to(cuda_device)
    _, _, _, basis, fb = tf._constants(cfg, cuda_device, torch.float32)
    buf, n_frames, _ = tf._framing_buffer(wav, n_fft, hop, None)
    buf = buf.contiguous()
    frames = tf.frame_signal(wav, n_fft, hop).reshape(-1, n_fft).contiguous()
    assert fused_kernel(torch.float32, n_fft, win, hop, 80) == "logmel_dmma_kernel"
    assert frames_kernel("highest", n_fft, win, 80) == "mel_frames_dmma_kernel"
    fused = [log_mel_fused(buf, None, basis, fb, n_frames=n_frames, hop=hop, win_length=win) for _ in range(2)]
    own = [log_mel_frames(frames, basis, fb, precision="highest", win_length=win) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(fused[0], fused[1]) and torch.equal(own[0], own[1])
    assert torch.equal(fused[0].reshape(-1, 80), own[0])


@pytest.mark.cuda
def test_f32_routes_by_geometry(cuda_device):
    """f32 at TitaNet's frontend takes the f64 tensor-core kernels; 64 mels,
    which they are not built for, the FP32-core ones (1e-4 either way)."""
    for n_mels, dmma in ((80, 1), (64, 0)):
        cfg = tf.FrontendConfig(n_mels=n_mels)
        _, _, _, basis, fb = tf._constants(cfg, cuda_device, torch.float32)
        wav = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 16000)) * 0.1).float().to(cuda_device)
        buf, n_frames, _ = tf._framing_buffer(wav, 512, 160, None)
        frames = tf.frame_signal(wav, 512, 160).reshape(-1, 512).contiguous()
        before = (log_mel_fused.dmma_launches, log_mel_frames.dmma_launches)
        out = log_mel_fused(buf.contiguous(), None, basis, fb, n_frames=n_frames, hop=160, win_length=400)
        fout = log_mel_frames(frames, basis, fb, precision="highest", win_length=400)
        torch.cuda.synchronize()
        assert (log_mel_fused.dmma_launches - before[0], log_mel_frames.dmma_launches - before[1]) == (dmma, dmma)
        ref = log_mel_fused_plain(buf.contiguous(), None, basis, fb, n_frames=n_frames, hop=160)
        assert out.shape[-1] == n_mels and (out - ref).abs().max().item() <= 1e-4
        assert (fout - log_mel_frames_plain(frames, basis, fb)).abs().max().item() <= 1e-4


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
def test_pool_backward_at_the_titanet_s_training_shape(cuda_device, fold):
    """TitaNet-S's training batch (B = 128, T = 301, C = 1536, H = 128,
    bf16), the backward's first stage on the one-pass kernel: each gradient
    within phase 6's 2e-2 of its largest entry (dbb, zero in exact
    arithmetic, below 2e-2 of max |dWb|)."""
    args = _pool_args(cuda_device, torch.bfloat16, b=128, t=301, c=1536, h=128, seed=11)
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((128, 3072)).astype(np.float32))
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
    kernel = frames_kernel(precision, n_fft, win, 80)
    if geometry == (512, 400, 160) and precision == "highest":
        assert kernel == "mel_frames_dmma_kernel"
    before = (log_mel_frames.launches, log_mel_frames.dmma_launches)
    out = log_mel_frames(frames, basis, fb, precision=precision, win_length=win)
    torch.cuda.synchronize()
    assert (log_mel_frames.launches - before[0], log_mel_frames.dmma_launches - before[1]) == (
        1, int(kernel == "mel_frames_dmma_kernel"))
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
# f32 (the 3xTF32 kernel; 76-row tiles at (256, 3), 52-row at (512, 7)): the
# same cases around its tiles
_MEGABLOCK_F32_SHAPES = [(b, t, c, k, 3) for c, k, tile in ((256, 3, 76), (512, 7, 52))
                         for t in (5, tile - 1, tile, tile + 1, 7 * tile + 13) for b in (1, 3)]
# both dtypes at C = 1024 (the cluster design; 108-row tiles at k = 11): the
# same cases around its tile
_MEGABLOCK_1024_SHAPES = [(b, t, 1024, 11, 3) for t in (5, 107, 108, 109, 3 * 108 + 13) for b in (1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,shape",
    [(dt, sh) for dt in (torch.float32, torch.bfloat16) for sh in _MEGABLOCK_SHAPES]
    + [(torch.bfloat16, sh) for sh in _MEGABLOCK_BF16_SHAPES]
    + [(torch.float32, sh) for sh in _MEGABLOCK_F32_SHAPES]
    + [(dt, sh) for dt in (torch.float32, torch.bfloat16) for sh in _MEGABLOCK_1024_SHAPES],
)
def test_megablock_kernel_matches_plain(cuda_device, dtype, shape):
    """Row by row, the edge rows included: f32 within 1e-4 of the largest
    entry (the product sums in another order, as 3xTF32 on the tensor cores
    at C = 128, 256 and 512), bf16 within one bf16 ulp of it (a depthwise
    sum on a rounding boundary). A second call gives the same bits. C =
    1024 runs the cluster design in both dtypes."""
    b, t, c, k, s = shape
    args = _chain_args(cuda_device, dtype, b, t, c, k, s)
    design = megablock.kernel_design(dtype, c)
    if dtype == torch.float32:
        assert design.startswith("tensor-core, 3xTF32 mma.sync")
    assert design.endswith(", cluster of 8" if dtype == torch.float32 else ", cluster of 4") == (c == 1024)
    before = megablock.fused_sub_blocks.launches
    out = megablock.fused_sub_blocks(*args, kernel_size=k)
    again = megablock.fused_sub_blocks(*args, kernel_size=k)
    torch.cuda.synchronize()
    assert megablock.fused_sub_blocks.launches == before + 2
    assert torch.equal(out, again)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("refusal", ["cluster of 16", "shared memory over the limit"])
def test_megablock_refused_cluster_launch_raises(cuda_device, dtype, refusal):
    """A cluster launch that the card refuses raises with the error that
    ``cudaLaunchKernelEx`` returned, and leaves no error behind: the design's
    own launch after it is right."""
    args = _chain_args(cuda_device, dtype, 1, 40, 1024, 11)
    n = megablock.CLUSTER_TILES[1024, dtype].blocks
    blocks, extra = (16, 0) if refusal == "cluster of 16" else (n, megablock.MAX_SMEM)
    assert megablock.max_active_clusters(dtype, 11) >= 1
    with pytest.raises(RuntimeError, match="mega-block kernel launch failed"):
        megablock.cluster_launch(*args, kernel_size=11, cluster_blocks=blocks, extra_smem=extra)
    out = megablock.cluster_launch(*args, kernel_size=11, cluster_blocks=n)
    torch.cuda.synchronize()
    ref = megablock.fused_sub_blocks_plain(*args, kernel_size=11)
    top = ref.float().abs().max().item()
    tol = 1e-4 * top if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_titanet_l_fused_call_launches_five_megablocks(cuda_device, dtype):
    """TitaNet-L from ``get_titanet(model_size="l")`` (5 mega-blocks,
    hidden 1024, k = 11): one fused call launches the frames log-mel kernel
    once and the mega-block kernel five times, and its embeddings are close
    to ``embed_step``'s (they differ in each mega-block's edge rows)."""
    from titanet_torch.models import get_titanet, l2_normalize
    from titanet_torch.models.fused_inference import titanet_apply_fused
    from titanet_torch.train.state import embed_step

    model = get_titanet(model_size="l", dtype=dtype, device=cuda_device, generator=torch.Generator().manual_seed(0))
    assert model.n_mega_blocks == 5 and model.mega_block_kernel_size == 11
    wav = np.random.default_rng(8).standard_normal((2, 48000)).astype(np.float32) * 0.1
    fe = tf.FrontendConfig.from_ms(precision="highest" if dtype is None else "default")
    log_mel_frames.launches = megablock.fused_sub_blocks.launches = 0
    mel, _ = log_mel_spectrogram_pallas(torch.from_numpy(wav).to(cuda_device), fe)
    emb = l2_normalize(titanet_apply_fused(model, mel)).float()
    torch.cuda.synchronize()
    assert log_mel_frames.launches == 1 and megablock.fused_sub_blocks.launches == 5
    ref = embed_step(model, wav, np.full(2, 48000, np.int32), frontend=fe, device=cuda_device).float()
    assert emb.shape == (2, 192) and torch.isfinite(emb).all()
    assert torch.nn.functional.cosine_similarity(emb, ref, dim=-1).min() > 0.99


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
    request's solo ``embed_step`` (no filler rows, no other requests). The
    embedder runs eagerly (``capture=False``): a graph's replay runs no
    Python, so only the eager route hands each launch's operands to
    ``keep``; the captured route is held in ``test_captured_*``."""
    from titanet_torch.models import get_titanet
    from titanet_torch.train.extractor import SpeakerEmbedder
    from titanet_torch.train.state import embed_step

    bf16 = precision == "default"
    model = get_titanet(n_mega_blocks=3, dtype=torch.bfloat16 if bf16 else None, device=cuda_device)
    fe = tf.FrontendConfig.from_ms(precision=precision, use_pallas_fused=True)
    embedder = SpeakerEmbedder(model, fe, batch_size=4, device=cuda_device, capture=False)
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
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_exported_fused_embedder_launches_the_kernels(cuda_device, dtype):
    """A model exported with the fused frontend launches the log-mel kernel
    once a call and, in bf16, the pool-forward kernel once a call (the
    registered operators); it equals ``embed_step`` of the same model:
    cosine drift under 1e-5 (the same kernels on the same inputs)."""
    from titanet_torch.models import get_titanet
    from titanet_torch.train.state import embed_step
    from titanet_torch.utils.export import export_titanet_embedder, load_embedder

    gen = torch.Generator().manual_seed(0)
    model = get_titanet(n_mega_blocks=1, dtype=dtype, device=cuda_device, generator=gen).eval()
    fe = tf.FrontendConfig(use_pallas_fused=True)
    served = load_embedder(export_titanet_embedder(model, None, fe, batch_size=2, num_samples=16000))
    rng = np.random.default_rng(4)
    wav = torch.from_numpy((rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)).to(cuda_device)
    lengths = torch.tensor([16000, 11000], dtype=torch.int32, device=cuda_device)
    mel_before, pool_before = log_mel_fused.launches, attentive_pool_fwd.launches
    with torch.no_grad():
        out = served(wav, lengths)
    torch.cuda.synchronize()
    assert log_mel_fused.launches - mel_before == 1
    assert attentive_pool_fwd.launches - pool_before == (1 if dtype == torch.bfloat16 else 0)
    ref = embed_step(model, wav, lengths, frontend=fe, device=cuda_device)
    assert out.dtype == ref.dtype and torch.isfinite(out).all()
    cos = torch.nn.functional.cosine_similarity(out.float(), ref.float(), dim=-1)
    assert (1.0 - cos).max().item() < 1e-5
    if dtype is None:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)

# ------------------------------------------------------------ step capture


def _capture_model(device, dtype=None, seed=0, n=2):
    from titanet_torch.models import get_titanet

    return get_titanet(n_mega_blocks=n, dtype=dtype, device=device,
                       generator=torch.Generator().manual_seed(seed)).eval()


def _capture_batch(device, seed=0, b=4, t=24000):
    rng = np.random.default_rng(seed)
    wav = torch.from_numpy((rng.standard_normal((b, t)) * 0.1).astype(np.float32)).to(device)
    lengths = torch.tensor([t, t - 5000, 9000, 1][:b], dtype=torch.int32, device=device)
    return wav, lengths


def _captured_steps(device, dtype, masked):
    """name -> fn(capture, wav, lengths) of every step captured on the card."""
    from titanet_torch.losses import build_head
    from titanet_torch.models.quantized import quantize_titanet
    from titanet_torch.train import state as ts

    model = _capture_model(device, dtype)
    fe = tf.FrontendConfig.from_ms(precision="default" if dtype else "highest", use_pallas_fused=True)
    head = build_head("ce", 192, 7, device=device)
    state = ts.TrainState(model=model, head=head, optimizer=None, opt_state=None, generator=None,
                          aug_generator=None, noise_generator=None)
    qtree = quantize_titanet(model) if dtype is None else None
    spk = torch.tensor([0, 3, 6, 1], device=device)
    steps = {
        "embed_step": lambda c, w, n: ts.embed_step(model, w, n, frontend=fe, masked=masked, device=device,
                                                    capture=c),
        "eval_step": lambda c, w, n: ts.eval_step(state, w, n, spk, frontend=fe, masked=masked, capture=c),
    }
    if qtree is not None:
        steps["embed_step_quantized"] = lambda c, w, n: ts.embed_step_quantized(
            qtree, w, n, frontend=fe, masked=masked, device=device, capture=c)
    return model, steps


def _leaves(out):
    return [t for t in torch.utils._pytree.tree_leaves(out) if t is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_captured_steps_equal_eager_to_the_bit(cuda_device, dtype, masked):
    """Each step through its graph (the capture call, then replays on new
    inputs of the same shape, int16 PCM too) equals ``capture=False`` to the
    bit; one graph a step and shape."""
    from titanet_torch.train.capture import GRAPHS

    _, steps = _captured_steps(cuda_device, dtype, masked)
    for name, step in steps.items():
        before = GRAPHS.captures
        for seed in (0, 1, 2):
            wav, lengths = _capture_batch(cuda_device, seed)
            got, want = step(None, wav, lengths), step(False, wav, lengths)
            for a, b in zip(_leaves(got), _leaves(want)):
                assert torch.equal(a, b), (name, seed)
        pcm = (wav * 32767).to(torch.int16)
        if name != "eval_step":
            for _ in range(2):
                assert torch.equal(step(None, pcm, lengths), step(False, pcm, lengths)), name
        assert GRAPHS.captures == before + (1 if name == "eval_step" else 2), name


@pytest.mark.cuda
def test_captured_embed_step_follows_in_place_updates_and_replacement(cuda_device):
    """A replay after ``load_state_dict`` and an in-place scale equals the
    eager step on the new weights with no new capture; parameters replaced
    by new storage (as ``model.to`` replaces them; a TitaNet's compute dtype
    is a constructor argument, so the test copies each in place of itself)
    change the key and capture again."""
    from titanet_torch.train.capture import GRAPHS
    from titanet_torch.train.state import embed_step

    model, donor = _capture_model(cuda_device, seed=0), _capture_model(cuda_device, seed=1)
    fe = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    wav, lengths = _capture_batch(cuda_device)
    run = lambda c: embed_step(model, wav, lengths, frontend=fe, masked=True, device=cuda_device, capture=c)  # noqa: E731
    first = run(None)
    captures = GRAPHS.captures
    model.load_state_dict(donor.state_dict())
    with torch.no_grad():
        model.encoder.prolog.conv.weight.mul_(0.5)
    got, want = run(None), run(False)
    assert GRAPHS.captures == captures and torch.equal(got, want) and not torch.equal(got, first)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.clone()
    again = run(None)
    assert GRAPHS.captures == captures + 1 and torch.equal(again, want)
    assert torch.equal(run(None), run(False))


@pytest.mark.cuda
def test_embedders_sharing_the_pool_keep_their_outputs(cuda_device):
    """Two embedders (two models, every bucket captured into the one pool)
    called in turns: each output equals its own eager embedding."""
    from titanet_torch.train.extractor import SpeakerEmbedder

    fe = tf.FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    embedders = [SpeakerEmbedder(_capture_model(cuda_device, torch.bfloat16, seed=s), fe, buckets=[16000, 32000],
                                 batch_size=4, device=cuda_device) for s in (0, 1)]
    eager = [SpeakerEmbedder(e.model, fe, buckets=[16000, 32000], batch_size=4, device=cuda_device, capture=False)
             for e in embedders]
    for e in embedders:
        e.warmup()
    rng = np.random.default_rng(3)
    for i in range(3):
        reqs = [(rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32) for s in (0.7, 1.6, 2.5)]
        for e, ref in zip(embedders, eager):
            np.testing.assert_array_equal(e.embed(reqs), ref.embed(reqs))


@pytest.mark.cuda
def test_counters_count_the_launches_of_replays(cuda_device):
    """A replay adds the launches its graph holds: one log-mel and (bf16,
    unmasked) one pool-forward launch a call, on the capture call and on
    every replay."""
    from titanet_torch.train.state import embed_step

    model = _capture_model(cuda_device, torch.bfloat16, seed=2)
    fe = tf.FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    wav, lengths = _capture_batch(cuda_device, b=3, t=20000)
    log_mel_fused.launches = log_mel_fused.tc_launches = attentive_pool_fwd.launches = 0
    for i in range(1, 5):
        embed_step(model, wav, lengths, frontend=fe, device=cuda_device)
        assert (log_mel_fused.launches, log_mel_fused.tc_launches, attentive_pool_fwd.launches) == (i, i, i)


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises(cuda_device):
    """No fallback: a step that reads a device value on the host runs in
    its warm-up and then fails its capture; the error reaches the caller
    and no graph is kept."""
    from titanet_torch.train.capture import StepGraphs

    graphs = StepGraphs()
    x = torch.ones(8, device=cuda_device)
    step = lambda t: t * float(t.sum().item())  # noqa: E731
    with pytest.raises(RuntimeError):
        graphs.run("host_read", None, (), step, (x,))
    assert len(graphs) == 0 and graphs.captures == 0
    torch.cuda.synchronize()
    assert torch.equal(x * 2, torch.full_like(x, 2.0))  # the device works on


def _train_state(device, dtype=torch.bfloat16, seed=0, remat=False, **opt_kw):
    from titanet_torch.losses import build_head
    from titanet_torch.models import common
    from titanet_torch.models.titanet import TitaNet
    from titanet_torch.train import state as ts

    model = common.finish(TitaNet(n_mega_blocks=2, dropout=0.5, dtype=dtype, remat=remat), device,
                          torch.Generator().manual_seed(seed))
    head = build_head("ce", 192, 7, device=device, generator=torch.Generator().manual_seed(1))
    return ts.create_train_state(model, head, ts.make_optimizer(grad_clip_norm=1.0, **opt_kw), seed=seed, ema=True)


def _train_record(st):
    opt = st.opt_state
    return ([*st.model.state_dict().values(), *st.head.state_dict().values(), *opt.mu, *opt.nu,
             *(opt.acc or []), *st.ema, *(g.get_state() for g in st.generators().values())],
            (st.step, opt.count, opt.mini_step))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("augment", [False, True])
def test_captured_train_step_equals_eager_to_the_bit(cuda_device, monkeypatch, route, augment):
    """Four train steps through the step's graph (a warm-up step that
    captures, then replays) against four ``capture=False`` steps from the
    same state: every parameter, running statistic, Adam moment, weight
    EMA, generator state, counter and metric to the bit; one graph a shape
    (uniform and ragged apart), accumulate and update apart."""
    from titanet_torch.ops.augment import AugmentConfig
    from titanet_torch.train import state as ts
    from titanet_torch.train.capture import GRAPHS

    monkeypatch.setenv("TITANET_DW_BWD", route)
    fe = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    wav, lengths = _capture_batch(cuda_device, b=4, t=24000)
    lengths[-1] = 12000
    spk = torch.tensor([0, 3, 6, 1], device=cuda_device)
    kw = dict(frontend=fe, ema_decay=0.9, augment=AugmentConfig(noise_prob=0.5) if augment else None)
    out, captures = [], GRAPHS.captures
    for capture in (None, False):
        st = _train_state(cuda_device, accumulate_steps=2)
        mets = []
        for i in range(4):
            st, m = ts.train_step(st, wav, None if i % 2 else lengths, spk, capture=capture, **kw)
            mets += [m["loss"], m["grad_norm"], m["embeddings"]]
        out.append((_train_record(st), mets))
    (a, ca), ma = out[0]
    (b, cb), mb = out[1]
    assert ca == cb == (4, 2, 0)
    assert all(torch.equal(x, y) for x, y in zip(a + ma, b + mb))
    # (ragged, accumulate) and (uniform, update), each replayed once
    assert GRAPHS.captures == captures + 2


@pytest.mark.cuda
def test_a_capture_drawing_from_an_unregistered_generator_raises(cuda_device):
    """A step registers each generator it draws from (an owner); one that
    is not registered fails its capture, never replays frozen draws."""
    from titanet_torch.train.capture import StepGraphs

    gen, other = (torch.Generator(device=cuda_device).manual_seed(s) for s in (0, 1))
    step = lambda x: x + torch.rand(x.shape, generator=other, device=x.device)  # noqa: E731
    graphs = StepGraphs()
    with pytest.raises(RuntimeError, match="not in capture mode"):
        graphs.run("draws", None, (gen,), step, (torch.zeros(8, device=cuda_device),))
    assert len(graphs) == 0
    state = gen.get_state()
    ok = lambda x: x + torch.rand(x.shape, generator=gen, device=x.device)  # noqa: E731
    x = torch.zeros(8, device=cuda_device)
    outs = [graphs.run("draws", None, (gen,), ok, (x,)) for _ in range(3)]
    ref = torch.Generator(device=cuda_device)
    ref.set_state(state)
    for o in outs:
        assert torch.equal(o, torch.rand(8, generator=ref, device=cuda_device))
    assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.cuda
def test_device_scalar_optimizer_equals_the_host_scalar_update_on_the_card(cuda_device):
    """The ``_foreach`` ops with the step's scalars as a device tensor give
    the bits the Python scalars gave (the replaced update), on the card."""
    import importlib.util
    import os

    from titanet_torch.train import state as ts

    # the CPU test file's cases and replaced update, loaded by path (it
    # imports neither JAX nor the JAX package)
    spec = importlib.util.spec_from_file_location(
        "train_capture_cases", os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_train_capture.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    OPT_CASES, ScalarOptimizer = cases.OPT_CASES, cases.ScalarOptimizer

    for case, (kw, scale) in sorted(OPT_CASES.items()):
        rng = np.random.default_rng(3)
        shapes = [(64, 33), (257,), ()]
        p0 = [torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32)).to(cuda_device) for s in shapes]
        new, old = ts.make_optimizer(**kw), ScalarOptimizer(**vars(ts.make_optimizer(**kw)))
        params = {k: [p.clone() for p in p0] for k in ("new", "old")}
        states = {"new": new.init(params["new"]), "old": old.init(params["old"])}
        for i in range(12):
            s = (3.0 if i % 2 else 0.05) if scale == "mixed" else scale
            g = [torch.from_numpy(np.asarray(rng.standard_normal(sh) * s, np.float32)).to(cuda_device) for sh in shapes]
            for name, opt in (("new", new), ("old", old)):
                upd = opt.update([x.clone() for x in g], states[name], params[name])
                if upd is not None:
                    torch._foreach_add_(params[name], upd)
            for a, b in zip(params["new"], params["old"]):
                assert torch.equal(a, b), (case, i)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_captured_remat_train_step_equals_the_plain_one(cuda_device, policy):
    """Two captured train steps of ``TitaNet(remat=True)`` equal the plain
    model's to the bit: the recompute runs inside the graph, the dropout
    masks are drawn once."""
    from titanet_torch.train import state as ts

    fe = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    wav, _ = _capture_batch(cuda_device, b=4, t=24000)
    spk = torch.tensor([0, 3, 6, 1], device=cuda_device)
    recs = []
    for remat in (False, True):
        st = _train_state(cuda_device, remat=remat)
        st.model.encoder.remat_policy = policy
        for _ in range(2):
            ts.train_step(st, wav, None, spk, frontend=fe)
        recs.append(_train_record(st))
    assert recs[0][1] == recs[1][1]
    assert all(torch.equal(x, y) for x, y in zip(recs[0][0], recs[1][0]))


@pytest.mark.cuda
def test_captured_shard_map_step_equals_eager_to_the_bit(cuda_device):
    """The ``shard_map`` step on one card (a mesh of size 1): four steps
    through its graph against four ``capture=False`` steps, dropout and
    SpecAugment drawn from the step's rank generators, reseeded before each
    call (a replay reads a registered generator's seed and offset, so it
    draws what a fresh generator of that step draws)."""
    from titanet_torch.parallel import make_mesh
    from titanet_torch.parallel.shard_map_step import make_shard_map_train_step
    from titanet_torch.train import capture as cap
    from titanet_torch.train import state as ts

    fe = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    wav, _ = _capture_batch(cuda_device, b=4, t=24000)
    spk = torch.tensor([0, 3, 6, 1], device=cuda_device)
    mesh = make_mesh(None, device=cuda_device)
    assert mesh.size == 1
    out, graphs = [], cap.StepGraphs()
    saved, ts.GRAPHS = ts.GRAPHS, graphs
    try:
        for capture in (None, False):
            st = _train_state(cuda_device)
            step = make_shard_map_train_step(mesh, model=st.model, head=st.head, optimizer=st.optimizer, frontend=fe,
                                             augment=(0.35, 1, 0.15, 1, 0.5), capture=capture)
            losses = [step(st, wav, None, spk)[1]["loss"] for _ in range(4)]
            out.append((_train_record(st), losses))
    finally:
        ts.GRAPHS = saved
    (a, ca), la = out[0]
    (b, cb), lb = out[1]
    assert ca == cb == (4, 4, 0) and graphs.captures == 1
    assert all(torch.equal(x, y) for x, y in zip(a + la, b + lb))


# ---------------------------------------------------------------- NCCL ranks
# The data-parallel steps as CUDA graphs on NCCL ranks, one card each
# (tests/torch_parallel_worker.py tasks nccl_capture and nccl_lost): they
# need two cards and skip on one. The spawning helpers are imported from
# this directory by their own name (pytest puts it on the path), since a
# package named ``tests`` elsewhere on the path can shadow this one.


@pytest.fixture(scope="module")
def nccl_ranks(tmp_path_factory):
    """Two NCCL ranks' results of the worker's ``nccl_capture`` task, with
    ``NCCL_ALGO=Ring`` in both (an eager and a captured all-reduce then sum
    in one order)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL refuses two ranks on one)")
    from torch_parallel_helpers import run_worker_ranks

    rng = np.random.default_rng(20)
    t = 24000
    tt = np.arange(t) / 16000
    wav = (rng.uniform(0.05, 0.5, (8, 1)) * np.sin(2 * np.pi * rng.uniform(100, 2000, (8, 1)) * tt)
           + 0.05 * rng.standard_normal((8, t))).astype(np.float32)
    inputs = {"wav": wav, "lengths": np.array([t, t - 5000, 9000, t, 12000, t, t - 3000, 16000], np.int32),
              "speakers": np.array([0, 3, 6, 1, 2, 5, 4, 7], np.int64), "widths": (t, 16000)}
    return run_worker_ranks("nccl_capture", inputs, tmp_path_factory.mktemp("nccl"), NCCL_ALGO="Ring")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["global", "accumulate", "shard_map"])
def test_nccl_captured_steps_equal_eager_to_the_bit(nccl_ranks, case):
    """Four steps of each rule through its graph (collectives inside)
    against four ``capture=False`` steps from one state: losses, every
    parameter, running statistic, Adam moment, weight EMA, the counters and
    each generator's state; one graph (two under accumulation)."""
    for r in nccl_ranks:
        eager, graph = r[case]["eager"], r[case]["graph"]
        assert r[case]["captures"] == (2 if case == "accumulate" else 1)
        assert all(torch.equal(a, b) for a, b in zip(eager["losses"], graph["losses"]))
        assert eager["state"].keys() == graph["state"].keys()
        for k, v in eager["state"].items():
            assert (v == graph["state"][k]) if not isinstance(v, torch.Tensor) else torch.equal(v, graph["state"][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["global", "accumulate", "shard_map"])
def test_nccl_collective_stats_count_replays_as_eager_steps(nccl_ranks, case):
    for r in nccl_ranks:
        eager, graph = r[case]["eager"]["stats"], r[case]["graph"]["stats"]
        assert graph == eager and eager["count"] > 0


@pytest.mark.cuda
def test_nccl_ranks_capture_on_the_same_calls(nccl_ranks):
    """Two bucket widths in turns: two graphs on every rank."""
    assert [r["widths_captures"] for r in nccl_ranks] == [2] * len(nccl_ranks)


@pytest.mark.cuda
def test_nccl_lost_rank_fails_the_others_within_the_timeout(tmp_path):
    """The last rank kills itself after launching a replay: the other
    rank's replayed collectives never finish, and it exits non-zero within
    ``TITANET_DIST_TIMEOUT`` plus a margin, never hangs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL refuses two ranks on one)")
    import time

    from torch_parallel_helpers import start_worker_ranks

    rng = np.random.default_rng(21)
    inputs = {"wav": (rng.standard_normal((8, 24000)) * 0.1).astype(np.float32),
              "speakers": np.arange(8, dtype=np.int64) % 7, "steps": 50, "kill_after": 4}
    timeout = 20
    procs, _ = start_worker_ranks("nccl_lost", inputs, tmp_path, TITANET_DIST_TIMEOUT=timeout)
    survivor, killed = procs
    margin = 60
    try:
        killed.communicate(timeout=240)
        t_kill = time.monotonic()
        survivor_out = survivor.communicate(timeout=timeout + margin)[0]
        waited = time.monotonic() - t_kill
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert killed.returncode == -9
    assert survivor.returncode != 0 and waited < timeout + margin, survivor_out[-2000:]
