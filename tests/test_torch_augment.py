"""The port's augmentation (titanet_torch/ops/augment.py) and the train
step's augment branch vs the JAX package on the CPU.

The deterministic pieces match the JAX functions in value: the stretch
matrix and the sinc kernel exactly, the resampler to 1e-6, a mask at given
uniforms exactly, and the SpecAugment frontend at a fixed rate with no
masks to 2e-5 (mel max-abs). The random draws come from a torch.Generator
and cannot replay a jax.random key, so masks and noise match the JAX
functions in distribution only (as FastDropout does, DIVERGENCES.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.losses import heads as th
from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.ops import augment as ta
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.ops.frontend import log_mel_spectrogram
from titanet_torch.train import state as ts
from titanet_torch.utils.weights import load_jax_train_state
from titanet_tpu.losses import heads as jh
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet
from titanet_tpu.ops import augment as ja
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.train import state as js

SMALL = dict(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256)


def _wave(seed=0, b=3, n=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tones = np.stack([np.sin(2 * np.pi * (180.0 * 1.7 ** i) * t) * 0.3 for i in range(b)])
    return (tones + rng.standard_normal((b, n)) * 0.05).astype(np.float32)


# ------------------------------------------------------- deterministic pieces


@pytest.mark.parametrize("rate", [0.95, 1.0, 1.0371, 1.05])
def test_stretch_interp_matrix_equals_jax(rate):
    ref = np.asarray(ja.stretch_interp_matrix(101, jnp.float32(rate)))
    got = ta.stretch_interp_matrix(101, torch.tensor(rate))
    np.testing.assert_array_equal(got.numpy(), ref)
    rates = torch.tensor([rate, 1.0])
    batched = ta.stretch_interp_matrix(101, rates)
    assert batched.shape == (2, 101, 103)
    np.testing.assert_array_equal(batched[0].numpy(), ref)


@pytest.mark.parametrize("freqs", [(16000, 8000), (16000, 22050), (16000, 12000), (48000, 16000)])
def test_sinc_resample_kernel_and_resample_match_jax(freqs):
    orig, new = freqs
    k_ref, w_ref = ja._sinc_resample_kernel(orig, new)
    k_got, w_got = ta._sinc_resample_kernel(orig, new)
    np.testing.assert_array_equal(k_got, k_ref)
    assert w_got == w_ref
    x = (np.random.default_rng(1).standard_normal((2, 4800)) * 0.2).astype(np.float32)
    ref = np.asarray(ja.resample(jnp.asarray(x), orig, new))
    got = ta.resample(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    out, n = ta.speed_perturb(torch.from_numpy(x), 16000, 1.1)
    assert n == out.shape[-1] == int(np.ceil(round(16000 / 1.1) * 4800 / 16000))


@pytest.mark.parametrize("axis,size", [(1, None), (0, None), (0, 37)])
def test_mask_at_given_uniforms_equals_jax(axis, size):
    """``mask_from_uniforms`` with the two uniforms JAX's mask_along_axis
    draws from its key gives JAX's mask, bit for bit."""
    spec = np.random.default_rng(2).standard_normal((50, 80)).astype(np.float32)
    param = 0.35 * 80 if axis == 1 else 0.15 * 50
    for seed in range(8):
        key = jax.random.key(seed)
        jsize = None if size is None else jnp.int32(size)
        ref = np.asarray(ja.mask_along_axis(key, jnp.asarray(spec), param, axis=axis, size=jsize))
        k1, k2 = jax.random.split(key)
        u = torch.tensor([[float(jax.random.uniform(k1)), float(jax.random.uniform(k2))]])
        tsize = None if size is None else torch.tensor([size], dtype=torch.int32)
        got = ta.mask_from_uniforms(torch.from_numpy(spec)[None], u[:, 0], u[:, 1], param,
                                    axis=axis + 1, size=tsize)[0].numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rate", [0.95, 1.05])
def test_log_mel_specaugment_at_a_fixed_rate_matches_jax(rate):
    wav, lens = _wave(3), np.array([16000, 12000, 9000], np.int32)
    kw = dict(min_rate=rate, max_rate=rate, freq_mask_num=0, time_mask_num=0, probability=1.0)
    ref, ref_mask = ja.log_mel_specaugment(jax.random.key(0), jnp.asarray(wav), JaxFrontend.from_ms(),
                                           ja.AugmentConfig(**kw), lengths=jnp.asarray(lens))
    got, got_mask = ta.log_mel_specaugment(torch.Generator().manual_seed(0), torch.from_numpy(wav),
                                           TorchFrontend.from_ms(), ta.AugmentConfig(**kw),
                                           lengths=torch.from_numpy(lens))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 2e-5


def test_log_mel_specaugment_with_probability_zero_equals_the_plain_log_mel():
    wav, lens = torch.from_numpy(_wave(4)), torch.tensor([16000, 11000, 7000])
    got, got_mask = ta.log_mel_specaugment(torch.Generator().manual_seed(0), wav, TorchFrontend.from_ms(),
                                           ta.AugmentConfig(probability=0.0), lengths=lens)
    ref, ref_mask = log_mel_spectrogram(wav, TorchFrontend.from_ms(), lengths=lens)
    assert torch.equal(got_mask, ref_mask)
    assert (got - ref).abs().max().item() <= 2e-6


def test_phase_vocoder_and_reverb_match_jax():
    rng = np.random.default_rng(5)
    spec = (rng.standard_normal((2, 65, 40)) + 1j * rng.standard_normal((2, 65, 40))).astype(np.complex64)
    ref = np.asarray(ja.phase_vocoder(jnp.asarray(spec), 1.1, 160, 128))
    got = ta.phase_vocoder(torch.from_numpy(spec), 1.1, 160, 128).numpy()
    assert got.shape == ref.shape
    # the frame positions j * rate come from each package's own f32 arange;
    # the accumulated phase reaches ~2e4 rad, where an f32 ulp is ~2e-3
    np.testing.assert_allclose(np.abs(got), np.abs(ref), atol=5e-5)
    assert np.abs(np.angle(got * np.conj(ref))).max() <= 5e-3
    x = (rng.standard_normal((2, 3000)) * 0.1).astype(np.float32)
    rir = rng.standard_normal(250).astype(np.float32)
    ref = np.asarray(ja.reverb(jnp.asarray(x), jnp.asarray(rir)))
    got = ta.reverb(torch.from_numpy(x), torch.from_numpy(rir)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ------------------------------------------------------- random pieces, in distribution


def test_random_masks_match_jax_in_distribution():
    """Mean width and start of the frequency and time masks over 4000 rows:
    the port's draws against JAX's (standard errors ~0.07 bins)."""
    n, frames, mels = 4000, 60, 80
    spec = np.ones((n, frames, mels), np.float32)
    valid = np.random.default_rng(0).integers(20, frames + 1, n).astype(np.int32)

    def stats(masked):
        freq = masked.max(axis=1) == 0  # [n, mels] masked mel bins
        time = masked.max(axis=2) == 0  # [n, frames] masked frames
        out = []
        for m in (freq, time):
            width = m.sum(axis=1)
            start = np.where(width > 0, m.argmax(axis=1), np.nan)
            out += [width.mean(), np.nanmean(start)]
        return np.array(out)

    def jax_one(key, s, v):
        k1, k2 = jax.random.split(key)
        s = ja.mask_along_axis(k1, s, 0.35 * mels, axis=1)
        return ja.mask_along_axis(k2, s, 0.15 * v, axis=0, size=v)

    keys = jax.random.split(jax.random.key(0), n)
    ref = np.asarray(jax.vmap(jax_one)(keys, jnp.asarray(spec), jnp.asarray(valid)))
    g = torch.Generator().manual_seed(0)
    got = ta.mask_along_axis(g, torch.from_numpy(spec), 0.35 * mels, axis=2)
    tv = torch.from_numpy(valid)
    got = ta.mask_along_axis(g, got, 0.15 * tv, axis=1, size=tv).numpy()
    s_ref, s_got = stats(ref), stats(got)
    # freq width ~ U(0, 28) (mean ~13.5), start mean ~26; time width mean ~2.5
    assert (np.abs(s_got - s_ref) <= np.array([0.6, 0.9, 0.15, 0.7])).all(), (s_got, s_ref)


@pytest.mark.parametrize("color", ["white", "pink"])
def test_add_noise_matches_jax_in_distribution(color):
    """Measured SNR over the valid samples lies in [snr_min, snr_max] for
    every gated row in both packages, with the same mean; padding stays
    zero; the gate opens for the same share of rows."""
    b, t = 512, 4000
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((b, t)) * rng.uniform(0.05, 0.5, (b, 1))).astype(np.float32)
    lens = rng.integers(1000, t + 1, b).astype(np.int32)
    wav[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    kw = dict(probability=0.5, snr_min=5.0, snr_max=20.0, color=color)
    ref = np.asarray(ja.add_noise(jax.random.key(0), jnp.asarray(wav), jnp.asarray(lens), **kw))
    got = ta.add_noise(torch.Generator().manual_seed(0), torch.from_numpy(wav), torch.from_numpy(lens),
                       **kw).numpy()

    def snr(out):
        valid = np.arange(t)[None, :] < lens[:, None]
        noise = out - wav
        gated = np.abs(noise).max(axis=1) > 0
        assert not (noise * ~valid).any()  # padding untouched
        p_sig = (wav ** 2 * valid).sum(1)
        p_noise = (noise ** 2 * valid).sum(1)
        return gated, 10 * np.log10(p_sig[gated] / p_noise[gated])

    (g_ref, s_ref), (g_got, s_got) = snr(ref), snr(got)
    assert 5.0 - 1e-3 <= s_got.min() and s_got.max() <= 20.0 + 1e-3
    assert abs(g_got.mean() - g_ref.mean()) < 0.1
    assert abs(s_got.mean() - s_ref.mean()) < 1.0


# ------------------------------------------------------- the train step's augment branch


def _states(seed=0):
    jm = JaxTitaNet(dropout=0.0, **SMALL)
    jhd = jh.build_head("ce", 192, 6)
    jopt = js.make_optimizer(name="sgd", start_lr=3e-4)
    jst = js.create_train_state(jax.random.key(seed), jm, jhd, jopt, jnp.zeros((2, 101, 80)), 6)
    tm = TorchTitaNet(dropout=0.0, **SMALL)
    thd = th.build_head("ce", 192, 6, device="cpu")
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    load_jax_train_state(tm, thd, tree(jst.params), tree(jst.batch_stats))
    return (jm, jhd, jopt, jst), ts.create_train_state(tm, thd, ts.make_optimizer(name="sgd", start_lr=3e-4))


def test_train_step_specaugment_at_a_fixed_rate_matches_jax():
    """f32, dropout 0, SpecAugment at rate 1.05 with no masks, noise off:
    the augment branch of both steps computes the same mel; loss within
    1e-4 over two steps."""
    (jm, jhd, jopt, jst), tst = _states()
    wav, lens, spk = _wave(6, b=4), np.array([16000, 12000, 16000, 9000], np.int32), np.arange(4)
    kw = dict(min_rate=1.05, max_rate=1.05, freq_mask_num=0, time_mask_num=0, probability=1.0)
    for _ in range(2):
        jst, jmet = js.train_step(jst, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(spk, jnp.int32),
                                  model=jm, head=jhd, optimizer=jopt, frontend=JaxFrontend.from_ms(),
                                  augment=ja.AugmentConfig(**kw))
        tst, tmet = ts.train_step(tst, wav, lens, spk, frontend=TorchFrontend.from_ms(),
                                  augment=ta.AugmentConfig(**kw))
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=1e-4)


def _torch_state(dropout=0.0):
    model = TorchTitaNet(dropout=dropout, **SMALL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    head = th.build_head("ce", 192, 6, device="cpu")
    return ts.create_train_state(model, head, ts.make_optimizer(start_lr=1e-3))


def test_train_step_augment_keeps_the_dropout_stream_and_each_generator_apart():
    """With augmentation the dropout generator advances exactly as without
    it; SpecAugment draws only from ``aug_generator`` and noise only from
    ``noise_generator``; the legacy 5-tuple runs too."""
    wav, spk = _wave(7, b=4), np.arange(4)
    fe = TorchFrontend.from_ms()
    states = {}
    for name, aug in (("none", None), ("spec", ta.AugmentConfig()),
                      ("noise", ta.AugmentConfig(specaugment=False, noise_prob=1.0)),
                      ("both", ta.AugmentConfig(noise_prob=1.0, noise_color="pink")),
                      ("tuple", (0.2, 1, 0.1, 1, 0.5))):
        tst = _torch_state(dropout=0.5)
        tst, met = ts.train_step(tst, wav, None, spk, frontend=fe, augment=aug)
        assert np.isfinite(met["loss"].item())
        states[name] = {k: g.get_state() for k, g in tst.generators().items()}
    fresh = {k: g.get_state() for k, g in _torch_state().generators().items()}
    for name, st in states.items():
        assert torch.equal(st["dropout"], states["none"]["dropout"]), name
        assert torch.equal(st["specaugment"], fresh["specaugment"]) == (name in ("none", "noise")), name
        assert torch.equal(st["noise"], fresh["noise"]) == (name in ("none", "spec", "tuple")), name
