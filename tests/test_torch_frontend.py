"""Port's frontend and fused-mel plain version vs the JAX package (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.ops import frontend as tf
from titanet_torch.ops.kernels.melspec import (
    log_mel_frames,
    log_mel_frames_plain,
    log_mel_fused,
    log_mel_fused_plain,
    log_mel_spectrogram_pallas,
)
from titanet_torch.ops.kernels import melspec as ms
from titanet_tpu.ops import frontend as jf
from tests.torch_port_helpers import fused_tc_walk

ATOL = 2e-5


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _wavs(seed, b, t, lengths=None):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    if lengths is not None:
        for i, n in enumerate(lengths):
            wav[i, n:] = 0.0
    return wav


def _port_fused(wav, cfg, lengths=None):
    """The port's fused route on CPU: framing buffer -> plain kernel."""
    lens = None if lengths is None else torch.as_tensor(lengths, dtype=torch.int32)
    out, _ = tf.log_mel_spectrogram(
        torch.from_numpy(wav), cfg._replace(use_pallas_fused=True), lengths=lens
    )
    return out.numpy()


def test_numpy_helpers_match_jax():
    for n_fft, win in ((512, 400), (256, 200)):
        np.testing.assert_array_equal(tf.padded_window(n_fft, win), jf.padded_window(n_fft, win))
        for a, b in zip(tf._dft_matrices(n_fft), jf._dft_matrices(n_fft)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tf.mel_filterbank(257, 80, 16000), jf.mel_filterbank(257, 80, 16000)
    )
    assert tf.FrontendConfig.from_ms().num_frames(48000) == 301
    assert tuple(tf.FrontendConfig.from_ms())[:5] == tuple(jf.FrontendConfig.from_ms())[:5]


@pytest.mark.parametrize("lengths", [None, [24000, 16000, 300]])
def test_frame_signal_matches_jax(lengths):
    wav = _wavs(1, 3, 24000, lengths)
    lj = None if lengths is None else jnp.asarray(lengths)
    lt = None if lengths is None else torch.as_tensor(lengths)
    ref = np.asarray(jf.frame_signal(jnp.asarray(wav), 512, 160, lengths=lj))
    out = tf.frame_signal(torch.from_numpy(wav), 512, 160, lengths=lt).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("lengths", [None, [24000, 16000]])
def test_log_mel_spectrogram_matches_jax(lengths):
    cfg_j, cfg_t = jf.FrontendConfig.from_ms(), tf.FrontendConfig.from_ms()
    wav = _wavs(2, 2, 24000, lengths)
    lj = None if lengths is None else jnp.asarray(lengths)
    lt = None if lengths is None else torch.as_tensor(lengths)
    ref, rmask = jf.log_mel_spectrogram(jnp.asarray(wav), cfg_j, lengths=lj)
    out, mask = tf.log_mel_spectrogram(torch.from_numpy(wav), cfg_t, lengths=lt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    if lengths is not None:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    # 1-D input squeezes like the JAX path
    ref1, _ = jf.log_mel_spectrogram(jnp.asarray(wav[0]), cfg_j)
    out1, _ = tf.log_mel_spectrogram(torch.from_numpy(wav[0]), cfg_t)
    assert out1.shape == ref1.shape
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), rtol=0, atol=ATOL)


@pytest.mark.parametrize("lengths", [None, [24000, 16000]])
def test_fused_plain_matches_pallas_fused_kernel(interpret_mode, lengths):
    """The CUDA kernel's plain version vs the Pallas kernel it replaces
    (interpret mode), f32, default geometry."""
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas_fused

    cfg = tf.FrontendConfig.from_ms()
    wav = _wavs(3, 2, 24000, lengths)
    lj = None if lengths is None else jnp.asarray(lengths)
    ref, _ = log_mel_spectrogram_pallas_fused(jnp.asarray(wav), jf.FrontendConfig.from_ms(), lengths=lj)
    np.testing.assert_allclose(_port_fused(wav, cfg, lengths), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("geometry", [(512, 400, 80), (256, 200, 160)])
def test_fused_plain_nondefault_geometry(interpret_mode, geometry):
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas_fused

    n_fft, win, hop = geometry
    wav = _wavs(5, 2, 16000)
    ref, _ = log_mel_spectrogram_pallas_fused(
        jnp.asarray(wav), jf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    )
    out = _port_fused(wav, tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=ATOL)


def test_fused_route_bf16_is_in_the_serving_error_class():
    """precision='default' (bf16 operands, f32 accumulation) stays within
    the ~5e-2 error class of the TPU kernel's serving precision."""
    wav = _wavs(6, 2, 24000)
    ref, _ = jf.log_mel_spectrogram(jnp.asarray(wav), jf.FrontendConfig.from_ms())
    out = _port_fused(wav, tf.FrontendConfig.from_ms(precision="default"))
    err = np.abs(out - np.asarray(ref)).max()
    assert 0 < err < 5e-2


def test_fused_wrapper_checks_inputs_and_counts_no_cpu_launch():
    cfg = tf.FrontendConfig.from_ms()
    _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.float32)
    buf = torch.zeros(2, 2000)
    before = log_mel_fused.launches
    out = log_mel_fused(buf, None, basis, fb, n_frames=10, hop=160)
    ref = log_mel_fused_plain(buf, None, basis, fb, n_frames=10, hop=160)
    assert torch.equal(out, ref) and out.shape == (2, 10, 80)
    assert log_mel_fused.launches == before
    with pytest.raises(ValueError):
        log_mel_fused(buf, None, basis, fb, n_frames=20, hop=160)  # buffer too short
    with pytest.raises(TypeError):
        log_mel_fused(buf.bfloat16(), None, basis, fb, n_frames=10, hop=160)
    with pytest.raises(ValueError):
        log_mel_fused(buf, torch.zeros(2, dtype=torch.int64), basis, fb, n_frames=10, hop=160)


@pytest.mark.parametrize("lengths", [None, [24000, 16000]])
def test_frames_route_matches_pallas_frames_kernel(interpret_mode, lengths):
    """log_mel_spectrogram_pallas (frames kernel's plain version on CPU) vs
    the Pallas frames kernel it replaces (interpret mode), f32, with the
    geometry and the masking of the JAX package's own test."""
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas as jax_route

    wav = _wavs(7, 2, 24000, lengths)
    lj = None if lengths is None else jnp.asarray(lengths)
    lt = None if lengths is None else torch.as_tensor(lengths)
    ref, rmask = jax_route(jnp.asarray(wav), jf.FrontendConfig.from_ms(), lengths=lj)
    out, mask = log_mel_spectrogram_pallas(torch.from_numpy(wav), tf.FrontendConfig.from_ms(), lengths=lt)
    assert out.shape == ref.shape == (2, 151, 80)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    if lengths is None:
        assert mask is None and rmask is None
    else:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
        assert not out[1, 101:].any()


@pytest.mark.parametrize("geometry", [(512, 400, 80), (256, 200, 160)])
def test_frames_route_nondefault_geometry(interpret_mode, geometry):
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas as jax_route

    n_fft, win, hop = geometry
    wav = _wavs(8, 2, 16000)
    ref, _ = jax_route(jnp.asarray(wav), jf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop))
    out, _ = log_mel_spectrogram_pallas(
        torch.from_numpy(wav), tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_frames_route_default_precision_is_in_the_serving_error_class(interpret_mode):
    """precision='default': the port rounds the operands of both products
    to bf16 as the card's kernel does; the JAX kernel on the CPU computes
    'default' in full f32, so only the ~5e-2 class can be held."""
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas as jax_route

    wav = _wavs(9, 2, 24000)
    ref, _ = jax_route(jnp.asarray(wav), jf.FrontendConfig.from_ms(precision="default"))
    out, _ = log_mel_spectrogram_pallas(torch.from_numpy(wav), tf.FrontendConfig.from_ms(precision="default"))
    err = np.abs(out.numpy() - np.asarray(ref)).max()
    assert 0 < err < 5e-2
    # and the fused route at that precision differs from it only in the
    # power's rounding (re^2 and im^2 apart, as _fused_kernel; once here, as
    # _mel_kernel): each mel sum moves by less than 2^-8 of itself, at most
    # 10*log10(1 + 2^-8) = 0.017 dB, under 1e-3 after the L2 norm of a row
    fused = _port_fused(wav, tf.FrontendConfig.from_ms(precision="default"))
    diff = np.abs(out.numpy() - fused).max()
    assert 0 < diff < 1e-3


def _bf16(a):
    """numpy f32 -> the nearest bf16 (ties to even), as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_frames_route_rounds_the_power_once_as_the_pallas_frames_kernel():
    """Fault 3 (repaired): ``_mel_kernel`` at DEFAULT precision sums
    ``re^2 + im^2`` in f32 and its dot rounds that sum to bf16 once; the
    frames route's plain version does the same. Emulated in numpy with the
    JAX package's own weights: frames, basis, power and fb rounded to bf16,
    products summed in f32. Each frame has two non-zero taps, so re and im
    are sums of two exact products and every summation order gives the
    same bits: the two agree to 1e-6. The two-rounding arithmetic of the
    fused kernel (re^2 and im^2 rounded apart) does not."""
    from titanet_tpu.ops.pallas.melspec import _fused_weights

    basis_j, fb_pad, n_bins = _fused_weights(jf.FrontendConfig.from_ms(precision="default"))
    bins_pad = fb_pad.shape[0]
    rng = np.random.default_rng(11)
    frames = np.zeros((32, 512), np.float32)
    for row in frames:
        row[rng.choice(np.arange(56, 456), 2, replace=False)] = rng.standard_normal(2) * 0.3
    spec = _bf16(frames) @ _bf16(basis_j)
    re, im = spec[:, :bins_pad], spec[:, bins_pad:]

    def normalized(mel):
        db = 10.0 * np.log10(np.maximum(mel, 1e-10))[:, :80]
        return db / np.maximum(np.linalg.norm(db, axis=-1, keepdims=True), 1e-12)

    fbb = _bf16(fb_pad)
    once = normalized(_bf16(re * re + im * im) @ fbb)
    apart = normalized(_bf16(re * re) @ fbb + _bf16(im * im) @ fbb)
    _, _, _, basis, fb = tf._constants(tf.FrontendConfig.from_ms(precision="default"),
                                       torch.device("cpu"), torch.bfloat16)
    port = log_mel_frames_plain(torch.from_numpy(frames), basis, fb, precision="default").numpy()
    assert np.abs(port - once).max() <= 1e-6
    assert np.abs(apart - once).max() > 1e-5


def test_frames_wrapper_checks_inputs_and_counts_no_cpu_launch():
    cfg = tf.FrontendConfig.from_ms()
    _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.float32)
    frames = torch.from_numpy(_wavs(10, 5, 512))
    before = log_mel_frames.launches
    out = log_mel_frames(frames, basis, fb, precision="highest", win_length=400)
    assert torch.equal(out, log_mel_frames_plain(frames, basis, fb, precision="highest"))
    assert out.shape == (5, 80) and log_mel_frames.launches == before
    with pytest.raises(TypeError):
        log_mel_frames(frames, basis, fb, precision="default")  # wants bf16 basis and fb
    with pytest.raises(TypeError):
        log_mel_frames(frames.bfloat16(), basis, fb)
    with pytest.raises(ValueError):
        log_mel_frames(frames[:, :400], basis, fb)
    with pytest.raises(ValueError):
        log_mel_frames(frames, basis, fb, precision="high")


@pytest.mark.parametrize("geometry", [(512, 400, 160), (512, 400, 80), (256, 200, 159)])
def test_fused_tc_walk_matches_pallas_fused_kernel(interpret_mode, geometry):
    """The walk of the fused tensor-core kernel vs the Pallas kernel it
    replaces at precision="default", in interpret mode: there the CPU takes
    the bf16 operands as they are, sums exact products in f32, and rounds
    ``spec * spec`` to bf16 column by column (re^2 and im^2 apart), the
    walk's arithmetic in another summation order. So the walk vs plain
    tolerance holds: under 1e-3, most entries within 1e-6. Five 0.5 s
    utterances (the last 128-row tile straddles them), masked."""
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas_fused

    n_fft, win, hop = geometry
    lengths = [8000, 6000, 3000, 8000, 700]
    wav = _wavs(12, 5, 8000, lengths)
    jcfg = jf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop, precision="default")
    ref, _ = log_mel_spectrogram_pallas_fused(jnp.asarray(wav), jcfg, lengths=jnp.asarray(lengths))
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop, precision="default")
    lens = torch.tensor(lengths, dtype=torch.int32)
    buf, n_frames, _ = tf._framing_buffer(torch.from_numpy(wav), n_fft, hop, lens)
    _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)
    got = fused_tc_walk(buf.bfloat16().contiguous(), lens, basis, fb, n_frames=n_frames, hop=hop,
                        win_length=win, dtype=torch.float32).numpy()
    assert got.shape == ref.shape == (5, n_frames, 80)
    err = np.abs(got - np.asarray(ref))
    assert err.max() < 1e-3 and (err > 1e-6).mean() < 0.05


def test_fused_tc_walk_rounds_re2_and_im2_apart_as_the_pallas_fused_kernel():
    """``_fused_kernel`` squares ``spec`` in f32 and rounds the squares to
    bf16 before its FB2 product, which repeats the filterbank over the re and
    im halves: re^2 and im^2 are rounded apart. Emulated in numpy with the
    JAX package's own weights (basis and fb rounded to bf16, products summed
    in f32). Samples 250 apart leave each frame's 400-tap window one or two
    non-zero taps, so re and im are sums of at most two exact products and
    every summation order gives the same bits: the tensor-core kernel's walk
    equals the apart-rounded emulation to 1e-6, and is further than 1e-5
    from the power rounded once (the frames route's arithmetic)."""
    from titanet_tpu.ops.pallas.melspec import _fused_weights

    basis_j, fb_pad, _ = _fused_weights(jf.FrontendConfig.from_ms(precision="default"))
    bins_pad = fb_pad.shape[0]
    rng = np.random.default_rng(13)
    n_frames, hop = 40, 160
    buf = np.zeros((2, (n_frames - 1) * hop + 512), np.float32)
    buf[:, 100::250] = rng.standard_normal(buf[:, 100::250].shape) * 0.3
    buf = torch.from_numpy(buf).bfloat16()
    frames = buf.unfold(1, 512, hop)[:, :n_frames].float().reshape(-1, 512).numpy()
    spec = frames @ _bf16(basis_j)
    re, im = spec[:, :bins_pad], spec[:, bins_pad:]

    def normalized(mel):
        db = 10.0 * np.log10(np.maximum(mel, 1e-10))[:, :80]
        return db / np.maximum(np.linalg.norm(db, axis=-1, keepdims=True), 1e-12)

    fbb = _bf16(fb_pad)
    apart = normalized(_bf16(re * re) @ fbb + _bf16(im * im) @ fbb)
    once = normalized(_bf16(re * re + im * im) @ fbb)
    _, _, _, basis, fb = tf._constants(tf.FrontendConfig.from_ms(precision="default"),
                                       torch.device("cpu"), torch.bfloat16)
    walk = fused_tc_walk(buf, None, basis, fb, n_frames=n_frames, hop=hop, win_length=400,
                         dtype=torch.float32).reshape(-1, 80).numpy()
    assert np.abs(walk - apart).max() <= 1e-6
    assert np.abs(walk - once).max() > 1e-5


def test_fused_wrapper_runs_plain_on_cpu_for_either_route():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch, on the tensor-core route's geometry (bf16, 80 mels) as on
    ``logmel_kernel``'s (64 mels)."""
    for n_mels in (80, 64):
        cfg = tf.FrontendConfig.from_ms(precision="default", n_mels=n_mels)
        assert ms.fused_tc_supports(cfg.n_fft, cfg.win_length, n_mels) == (n_mels == 80)
        _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.bfloat16)
        buf = torch.from_numpy(_wavs(14, 2, 2000)).bfloat16()
        before = (log_mel_fused.launches, log_mel_fused.tc_launches)
        out = log_mel_fused(buf, None, basis, fb, n_frames=10, hop=160, win_length=400)
        assert torch.equal(out, log_mel_fused_plain(buf, None, basis, fb, n_frames=10, hop=160))
        assert (log_mel_fused.launches, log_mel_fused.tc_launches) == before
