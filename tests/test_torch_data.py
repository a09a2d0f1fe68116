"""The port's host data layer (titanet_torch/config.py, titanet_torch/data/)
vs the JAX package on the CPU: configs load to equal dictionaries, the
synthetic corpus and the splits are identical, the loader yields the same
batches bit for bit (chunk, speed, reverb and the noise mix on), the
on-disk corpora read local directories alike, and audio decodes to the same
samples (WAV, and FLAC through the port's own build of native/audioio.cpp)."""

import glob
import os

import numpy as np
import pytest
import torch

from flac_fixture import encode_flac
from titanet_torch import config as tc
from titanet_torch import data as td
from titanet_torch.utils import set_seed
from titanet_tpu import config as jc
from titanet_tpu import data as jd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_to_the_jax_dicts(path):
    assert tc.load_config(path).to_dict() == jc.load_config(path).to_dict()


def test_config_overrides_defaults_and_errors_match_jax():
    over = {"training.batch_size": 32, "augmentation.enable": ["chunk", "noise"], "titanet.model_size": "m"}
    assert tc.load_config(None, over).to_dict() == jc.load_config(None, over).to_dict()
    assert tc.Config().to_dict() == jc.Config().to_dict()
    for bad in ({"training": {"nope": 1}}, {"training": {"loss": "hinge"}}):
        with pytest.raises((ValueError, AssertionError)):
            tc.Config.from_dict(bad)
        with pytest.raises((ValueError, AssertionError)):
            jc.Config.from_dict(bad)
    with pytest.raises(ValueError):
        tc.apply_overrides(tc.Config(), {"training.nope": 1})


@pytest.mark.parametrize("kw", [
    dict(n_speakers=5, utterances_per_speaker=6, seed=3),
    dict(n_speakers=4, utterances_per_speaker=5, seed=1, formant_jitter=40.0, reverb_prob=0.5,
         f0_range=(100.0, 140.0), noise_level=0.05, cache=False),
])
def test_synthetic_waveforms_and_splits_are_identical(kw):
    ref, got = jd.SyntheticSpeakerDataset(**kw), td.SyntheticSpeakerDataset(**kw)
    assert len(ref) == len(got) and ref.speakers_utterances == got.speakers_utterances
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        np.testing.assert_array_equal(b["waveform"], a["waveform"])
        assert (b["sample_rate"], b["speaker"], b["speaker_id"]) == (a["sample_rate"], a["speaker"], a["speaker_id"])
    split_kw = dict(val_utterances_per_speaker=1, test_speakers=2, test_utterances_per_speaker=2)
    for exclusive in (False, True):
        r = jd.get_datasets("", name="synthetic", exclusive_test_speakers=exclusive, **split_kw, **kw)
        g = td.get_datasets("", name="synthetic", exclusive_test_speakers=exclusive, **split_kw, **kw)
        assert r[3] == g[3]
        for a, b in zip(r[:3], g[:3]):
            assert a.indices == b.indices and a.speakers_utterances == b.speakers_utterances


def _write_wavs(root, specs, rng):
    paths = []
    for name, freq, seconds in specs:
        t = np.arange(int(seconds * 16000)) / 16000.0
        wav = (np.sin(2 * np.pi * freq * t) * 0.2 + rng.standard_normal(t.size) * 0.02).astype(np.float32)
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jd.write_wav(path, wav[None], 16000)
        paths.append(path)
    return tuple(paths)


@pytest.mark.parametrize("continuous", [False, True])
def test_loader_batches_equal_the_jax_loader_bit_for_bit(tmp_path, continuous):
    """Three epochs of shuffled batches with chunking, speed perturbation,
    reverb and the noise mix from WAV files, int16 transport and two decode
    workers: every batch equal to the JAX loader's."""
    rng = np.random.default_rng(0)
    noise = _write_wavs(str(tmp_path), [("noise/a.wav", 300.0, 0.4), ("noise/b.wav", 900.0, 1.3)], rng)
    rirs = _write_wavs(str(tmp_path), [("rir/r.wav", 50.0, 0.05)], rng)
    kw = dict(n_speakers=4, utterances_per_speaker=6, min_seconds=1.2, max_seconds=3.5, seed=2)

    def loader(pkg):
        return pkg.DataLoader(
            pkg.SyntheticSpeakerDataset(**kw), batch_size=4, shuffle=True, seed=11, num_workers=2,
            chunk=pkg.ChunkConfig(max_length=2.0, lengths=(1.5, 2.0)),
            # rates whose resampling ratios reduce to 5:4 and 4:5 keep the
            # polyphase kernels small (0.95 gives 8000:8421)
            speed=pkg.SpeedConfig(rates=(0.8, 1.0, 1.25), probability=0.7, enabled=True,
                                  continuous=continuous),
            reverb=pkg.ReverbConfig(rir_paths=rirs, probability=0.5, enabled=True),
            noise=pkg.NoiseMixConfig(paths=noise, probability=0.6, snr_min=5.0, snr_max=15.0, enabled=True),
            transport_dtype="int16",
        )

    ref, got = loader(jd), loader(td)
    assert ref.buckets == got.buckets and len(ref) == len(got)
    for epoch in range(3):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        pairs = list(zip(ref, got))
        assert len(pairs) == len(ref)
        for a, b in pairs:
            for key in ("waveform", "lengths", "speaker_ids"):
                np.testing.assert_array_equal(getattr(b, key), getattr(a, key))
                assert getattr(b, key).dtype == getattr(a, key).dtype


def test_balanced_and_unchunked_float_loaders_equal_the_jax_loaders():
    kw = dict(n_speakers=6, utterances_per_speaker=4, seed=4)
    for extra in (dict(batch_size=6, balanced=(3, 2)), dict(batch_size=5, shuffle=False, drop_last=False,
                                                             chunk=None, cache_waveforms=True)):
        ref = jd.DataLoader(jd.SyntheticSpeakerDataset(**kw), seed=5, prefetch=0, **extra)
        got = td.DataLoader(td.SyntheticSpeakerDataset(**kw), seed=5, prefetch=0, **extra)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b.waveform, a.waveform)
            np.testing.assert_array_equal(b.speaker_ids, a.speaker_ids)
        assert len(list(got)) == len(ref)


def test_device_prefetch_on_the_cpu_yields_the_host_batches():
    loader = td.DataLoader(td.SyntheticSpeakerDataset(n_speakers=3, utterances_per_speaker=4),
                           batch_size=4, prefetch=0, transport_dtype="int16")
    staged = list(td.device_prefetch(loader, device="cpu", size=2))
    assert len(staged) == len(loader)
    for (tensors, batch), ref in zip(staged, loader):
        for key in ("waveform", "lengths", "speaker_ids"):
            assert torch.equal(tensors[key], torch.from_numpy(getattr(ref, key)))
            np.testing.assert_array_equal(getattr(batch, key), getattr(ref, key))


def test_resample_host_matches_jax():
    from titanet_torch.data.loader import _resample_host as t_res
    from titanet_tpu.data.loader import _resample_host as j_res

    x = np.random.default_rng(3).standard_normal(7001).astype(np.float32)
    for orig, new in ((16000, 16000), (16000, 15238), (22050, 16000), (48000, 16000)):
        np.testing.assert_array_equal(t_res(x, orig, new), j_res(x, orig, new))


def _pcm(seed, channels, n):
    steps = np.random.default_rng(seed).integers(-400, 400, (channels, n))
    return np.clip(np.cumsum(steps, axis=1), -12000, 12000).astype(np.int64)


@pytest.mark.parametrize("channels,mode", [(1, "lpc"), (2, "fixed2"), (1, "verbatim")])
def test_wav_and_flac_decode_to_the_jax_samples(tmp_path, channels, mode):
    pcm = _pcm(channels, channels, 9000)
    flac = tmp_path / "x.flac"
    flac.write_bytes(encode_flac(pcm, 16000, mode=mode, stereo_mode="left_side" if channels == 2 else "independent"))
    wav = str(tmp_path / "x.wav")
    td.write_wav(wav, pcm / 32768.0, 16000)
    for path in (str(flac), wav):
        got, sr = td.read_audio(path)
        ref, ref_sr = jd.read_audio(path)
        assert sr == ref_sr == 16000 and got.shape == (channels, 9000)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pcm / 32768.0)


def test_flac_decoder_is_built_into_the_port_build_dir():
    from titanet_torch.data import native

    native._load()
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == "_build" and lib.parent.parent.name == "titanet_torch"


def _corpora(root, rng):
    """Tiny LibriSpeech (FLAC), VCTK (FLAC) and VoxCeleb (WAV) layouts."""
    for spk in (19, 26):
        for utt in range(3):
            p = os.path.join(root, "LibriSpeech", "train-clean-100", str(spk), "198", f"{spk}-198-{utt:04d}.flac")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(encode_flac(_pcm(spk * 10 + utt, 1, 3000), 16000, mode="fixed1"))
    for spk in ("p225", "p226"):
        for utt in range(2):
            p = os.path.join(root, "wav48_silence_trimmed", spk, f"{spk}_{utt:03d}_mic2.flac")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(encode_flac(_pcm(utt + 7, 1, 2500), 48000, mode="lpc"))
    for spk in ("id001", "id002"):
        for utt in range(3):
            p = os.path.join(root, "wav", spk, "v0", f"u{utt}.wav")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            jd.write_wav(p, rng.standard_normal(4000).astype(np.float32)[None] * 0.1, 16000)


@pytest.mark.parametrize("name", ["librispeech", "vctk", "voxceleb1", "voxceleb2", "voxceleb1+synthetic"])
def test_on_disk_corpora_read_like_jax(tmp_path, name):
    _corpora(str(tmp_path), np.random.default_rng(0))
    kw = dict(val_utterances_per_speaker=1, test_speakers=1, test_utterances_per_speaker=1)
    if "synthetic" in name:
        kw.update(n_speakers=2, utterances_per_speaker=3, seed=0)
    ref = jd.get_datasets(str(tmp_path), name=name, **kw)
    got = td.get_datasets(str(tmp_path), name=name, **kw)
    assert got[3] == ref[3]
    for a, b in zip(ref[:3], got[:3]):
        assert b.indices == a.indices and b.speakers == a.speakers
        for i in range(len(a)):
            x, y = a[i], b[i]
            np.testing.assert_array_equal(y["waveform"], x["waveform"])
            assert (y["speaker"], y["speaker_id"], y["sample_rate"]) == (x["speaker"], x["speaker_id"], x["sample_rate"])


def _archive(src, member, dest):
    """``src/member`` packed into ``dest`` (.tar.gz or .zip), paths kept
    relative to ``src``."""
    import shutil

    fmt = "gztar" if str(dest).endswith(".tar.gz") else "zip"
    base = str(dest)[: -len(".tar.gz")] if fmt == "gztar" else str(dest)[: -len(".zip")]
    return shutil.make_archive(base, fmt, root_dir=src, base_dir=member)


@pytest.mark.parametrize("cls", ["LibriSpeechDataset", "VCTKDataset", "VoxCelebDataset"])
def test_fetching_a_missing_corpus_raises_and_names_the_roadmap_item(tmp_path, cls):
    """``download=True`` fetches a missing corpus through
    ``titanet_torch.data.acquire`` from a local ``file://`` archive (the
    VoxCeleb one in two parts), and the corpus then reads like the JAX
    package's over the same directory; without ``download`` a missing
    corpus still raises FileNotFoundError."""
    src = tmp_path / "src"
    _corpora(str(src), np.random.default_rng(0))
    root = tmp_path / "root"
    if cls == "LibriSpeechDataset":
        url = "file://" + _archive(src, "LibriSpeech", tmp_path / "train-clean-100.tar.gz")
        got = td.LibriSpeechDataset(str(root), download=True, source_url=url)
        ref = jd.LibriSpeechDataset(str(root))
    elif cls == "VCTKDataset":
        url = "file://" + _archive(src, "wav48_silence_trimmed", tmp_path / "VCTK-Corpus-0.92.zip")
        got = td.VCTKDataset(str(root), download=True, source_url=url)
        ref = jd.VCTKDataset(str(root))
    else:
        blob = open(_archive(src, "wav", tmp_path / "vox1_dev_wav.zip"), "rb").read()
        half = len(blob) // 2
        parts = []
        for i, piece in enumerate((blob[:half], blob[half:])):
            part = tmp_path / f"vox1_dev_wav_parta{'ab'[i]}"
            part.write_bytes(piece)
            parts.append(f"file://{part}")
        got = td.VoxCelebDataset(str(root), download=True, version=1, dev_urls=parts, test_url=None,
                                 progress=False)
        ref = jd.VoxCelebDataset(str(root))
    assert len(got) == len(ref) > 0 and got.speakers == ref.speakers
    for i in range(len(ref)):
        x, y = ref.get_sample(i), got.get_sample(i)
        np.testing.assert_array_equal(y[0], x[0])
        assert y[1:] == x[1:]
    assert not [p for p in os.listdir(root) if p.endswith((".zip", ".tar.gz"))]  # archives removed
    with pytest.raises(FileNotFoundError):
        getattr(td, cls)(str(tmp_path / "missing"))


def test_set_seed_seeds_every_global_generator_and_returns_a_generator():
    g = set_seed(7)
    a = (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    g = set_seed(7)
    assert a == (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    assert isinstance(g, torch.Generator)
