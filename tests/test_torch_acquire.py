"""The port's corpus acquisition (titanet_torch/data/acquire.py,
titanet_torch/utils/download.py): the seven cases of tests/test_acquire.py
against the port. The whole download/extract/convert pipelines run against
local file:// archives, the m4a transcoder is a stub, and the fetched
corpora read through the port's dataset classes; two more cases fetch the
noise and RIR corpora through ``cli.train`` (``augmentation.noise.download``
and ``augmentation.rir.download``)."""

import os
import shutil
import tarfile
import wave
import zipfile
from pathlib import Path

import numpy as np
import pytest

from flac_fixture import encode_flac
from titanet_torch.data.acquire import (
    convert_m4a_tree,
    fetch_librispeech,
    fetch_rir_corpus,
    fetch_voxceleb2,
    reassemble_parts,
)
from titanet_torch.data.dataset import LibriSpeechDataset, VoxCelebDataset


def _write_wav(path, n=800, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(n) * 3000).astype(np.int16)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return pcm


def _write_flac(path, n=1600, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((1, n)) * 3000).astype(np.int32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_flac(pcm, sample_rate=sr))


def test_librispeech_download_via_file_url(tmp_path):
    # build a tiny LibriSpeech-layout corpus and tar.gz it
    src = tmp_path / "src"
    for spk, chap, utt in ((19, 198, 0), (19, 198, 1), (26, 495, 0)):
        _write_flac(
            src / "LibriSpeech" / "train-clean-100" / str(spk) / str(chap)
            / f"{spk}-{chap}-{utt:04d}.flac",
            seed=spk + utt,
        )
    archive = tmp_path / "train-clean-100.tar.gz"
    with tarfile.open(archive, "w:gz") as tar:
        tar.add(src / "LibriSpeech", arcname="LibriSpeech")

    root = tmp_path / "data"
    ds = LibriSpeechDataset(
        str(root), download=True, source_url=f"file://{archive}"
    )
    assert len(ds) == 3
    assert ds.get_num_speakers() == 2
    wav, sr, speaker = ds.get_sample(0)
    assert sr == 16000 and wav.shape[-1] == 1600 and speaker == 19
    assert not (root / "train-clean-100.tar.gz").exists()  # archive removed
    # the fetched corpus reads as the JAX package reads it
    from titanet_tpu.data.dataset import LibriSpeechDataset as JaxLibriSpeech

    ref = JaxLibriSpeech(str(root))
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.get_sample(i)[0], ref.get_sample(i)[0])
    # idempotent: a second call reuses the extracted corpus
    assert fetch_librispeech(str(root)) == str(
        root / "LibriSpeech" / "train-clean-100"
    )


def test_fetch_rir_corpus_via_file_url(tmp_path):
    src = tmp_path / "rir_src"
    _write_wav(src / "RIRS_NOISES" / "simulated_rirs" / "smallroom" / "rir1.wav")
    archive = tmp_path / "rirs_noises.zip"
    with zipfile.ZipFile(archive, "w") as z:
        for p in Path(src).rglob("*.wav"):
            z.write(p, p.relative_to(src))
    dest = tmp_path / "rirs"
    fetch_rir_corpus(str(dest), source_url=f"file://{archive}")
    found = list(Path(dest).rglob("*.wav"))
    assert len(found) == 1
    assert not (dest / "rirs_noises.zip").exists()


def test_reassemble_parts_roundtrip(tmp_path):
    blob = os.urandom(100_000)
    parts = []
    for i in range(3):
        p = tmp_path / f"part{i}"
        p.write_bytes(blob[i * 40_000 : (i + 1) * 40_000])
        parts.append(str(p))
    out = reassemble_parts(parts, str(tmp_path / "whole"))
    assert Path(out).read_bytes() == blob


def test_voxceleb2_pipeline_via_file_urls(tmp_path):
    """Multi-part download -> reassembly -> extraction -> m4a->wav via a
    pluggable transcoder -> aac/ moved to wav/ -> VoxCelebDataset loads."""
    # an "aac" tree with fake .m4a payloads
    src = tmp_path / "vox_src"
    utts = [("id00001", "vid1", "00001"), ("id00001", "vid1", "00002"),
            ("id00002", "vid9", "00001")]
    for spk, vid, utt in utts:
        p = src / "aac" / spk / vid / f"{utt}.m4a"
        os.makedirs(p.parent, exist_ok=True)
        p.write_bytes(b"fake-aac-" + utt.encode())
    dev_zip = tmp_path / "vox2_dev_aac.zip"
    with zipfile.ZipFile(dev_zip, "w") as z:
        for p in Path(src).rglob("*.m4a"):
            z.write(p, p.relative_to(src))
    # split into 3 authed "parts" served over file://
    blob = dev_zip.read_bytes()
    step = -(-len(blob) // 3)
    part_urls = []
    for i in range(3):
        part = tmp_path / f"vox2_dev_aac_part a{chr(97 + i)}".replace(" ", "")
        part.write_bytes(blob[i * step : (i + 1) * step])
        part_urls.append(f"file://{part}")

    def transcode(src_path, dst_path, sample_rate):
        assert src_path.endswith(".m4a")
        _write_wav(dst_path, n=640, sr=sample_rate)

    root = tmp_path / "vox2"
    wav_dir = fetch_voxceleb2(
        str(root), dev_urls=part_urls, test_url=None, test_sha256=None,
        username="user", password="pass", transcode=transcode, progress=False,
    )
    wavs = sorted(Path(wav_dir).rglob("*.wav"))
    assert len(wavs) == 3
    assert not list(Path(root).rglob("*.m4a"))  # originals removed
    ds = VoxCelebDataset(str(root))
    assert len(ds) == 3 and ds.get_num_speakers() == 2
    wav, sr, speaker = ds.get_sample(0)
    assert sr == 16000 and speaker == "id00001"


def test_convert_m4a_tree_counts_and_removes(tmp_path):
    (tmp_path / "a.m4a").write_bytes(b"x")
    (tmp_path / "b.m4a").write_bytes(b"y")
    (tmp_path / "keep.wav").write_bytes(b"z")

    def transcode(src, dst, sr):
        shutil.copy(src, dst)

    n = convert_m4a_tree(str(tmp_path), ["a.m4a", "b.m4a", "keep.wav"],
                         transcode=transcode)
    assert n == 2
    assert not (tmp_path / "a.m4a").exists()
    assert (tmp_path / "a.wav").exists() and (tmp_path / "keep.wav").exists()


def test_voxceleb1_download_via_file_url(tmp_path):
    """VoxCeleb1 routing: multi-part WAV archives,
    no transcode step; VoxCelebDataset(download=True, version=1) must reach
    fetch_voxceleb1, not the v2 fetcher."""
    from titanet_torch.data.acquire import fetch_voxceleb1

    src = tmp_path / "vox1_src"
    utts = [("id10001", "clipA", "00001"), ("id10001", "clipA", "00002"),
            ("id10270", "clipB", "00001")]
    for spk, vid, utt in utts:
        _write_wav(src / "wav" / spk / vid / f"{utt}.wav", seed=hash(utt) % 97)
    dev_zip = tmp_path / "vox1_dev_wav.zip"
    with zipfile.ZipFile(dev_zip, "w") as z:
        for p in Path(src).rglob("*.wav"):
            z.write(p, p.relative_to(src))
    blob = dev_zip.read_bytes()
    step = -(-len(blob) // 2)
    part_urls = []
    for i in range(2):
        part = tmp_path / f"vox1_dev_wav_parta{chr(97 + i)}"
        part.write_bytes(blob[i * step : (i + 1) * step])
        part_urls.append(f"file://{part}")

    root = tmp_path / "vox1"
    ds = VoxCelebDataset(
        str(root), download=True, version=1,
        dev_urls=part_urls, test_url=None, progress=False,
    )
    assert len(ds) == 3 and ds.get_num_speakers() == 2
    wav, sr, speaker = ds.get_sample(0)
    assert sr == 16000 and speaker == "id10001"
    # idempotent: second call sees wav/ and skips downloading
    assert fetch_voxceleb1(str(root), dev_urls=part_urls, test_url=None) == str(
        root / "wav"
    )


def test_voxceleb_bad_version_rejected(tmp_path):
    import pytest

    with pytest.raises(ValueError, match="version"):
        VoxCelebDataset(str(tmp_path / "nope"), download=True, version=3)


@pytest.mark.parametrize("kind", ["noise", "rir"])
def test_cli_train_fetches_the_noise_and_rir_corpora(tmp_path, monkeypatch, kind):
    """``augmentation.noise.download`` (MUSAN) and
    ``augmentation.rir.download`` (OpenSLR-28) with an empty corpora
    directory: ``cli.train`` fetches the corpus (its URL pointed at a local
    archive; any other URL fails the test) and trains one epoch with the
    host-side noise mix or reverb drawing from it."""
    import urllib.request

    from titanet_torch import cli
    from titanet_torch.config import Config
    from titanet_torch.data import acquire
    from titanet_torch.train import checkpoint as ckpt

    urlopen = urllib.request.urlopen

    def local_only(request, *a, **k):
        url = request.full_url if hasattr(request, "full_url") else request
        assert url.startswith("file://"), url
        return urlopen(request, *a, **k)

    monkeypatch.setattr(urllib.request, "urlopen", local_only)
    src = tmp_path / "src"
    if kind == "noise":
        _write_wav(src / "musan" / "noise" / "free-sound" / "noise-0001.wav", n=8000, seed=3)
        archive = tmp_path / "musan.tar.gz"
        with tarfile.open(archive, "w:gz") as tar:
            tar.add(src / "musan", arcname="musan")
        monkeypatch.setattr(acquire, "MUSAN_URL", f"file://{archive}")
        aug = {"enable": ["noise"], "probability": 1.0,
               "noise": {"source": "files", "download": True, "corpora_path": str(tmp_path / "corpus")}}
    else:
        _write_wav(src / "RIRS_NOISES" / "simulated_rirs" / "smallroom" / "rir1.wav", n=400, seed=4)
        archive = tmp_path / "rirs_noises.zip"
        with zipfile.ZipFile(archive, "w") as z:
            for p in Path(src).rglob("*.wav"):
                z.write(p, p.relative_to(src))
        monkeypatch.setattr(acquire, "RIR_CORPORA_URL", f"file://{archive}")
        aug = {"enable": ["reverb"], "probability": 1.0,
               "rir": {"download": True, "corpora_path": str(tmp_path / "corpus")}}
    cfg = Config.from_dict({
        "dataset": {"name": "synthetic", "synthetic_speakers": 2, "synthetic_utterances": 4},
        "training": {"batch_size": 4, "epochs": 1, "checkpoints_path": str(tmp_path / "ck"), "run_name": kind},
        "validation": {"enabled": False}, "test": {"enabled": False},
        "dumb": {"enabled": True, "hidden_size": 16, "n_layers": 1},
        "augmentation": aug, "generic": {"workers": 0},
    })
    cli.train(cfg, device="cpu")
    fetched = sorted(Path(tmp_path / "corpus").rglob("*.wav"))
    assert len(fetched) == 1 and not list(Path(tmp_path / "corpus").glob("*.zip"))
    assert not list(Path(tmp_path / "corpus").glob("*.tar.gz"))
    assert ckpt.latest_epoch(str(tmp_path / "ck" / kind)) == 1
