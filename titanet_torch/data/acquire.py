"""Corpus acquisition (port of ``titanet_tpu/data/acquire.py``):
download, extract and convert hooks for the on-disk corpora.

- LibriSpeech download when the root is missing (reference
  ``src/datasets.py:303-306`` via torchaudio's downloader),
- VCTK 0.92 download (``src/datasets.py:340-343``),
- VoxCeleb1 multi-part wav archives; VoxCeleb2 multi-part authenticated
  download, zip reassembly and parallel m4a->wav conversion
  (``src/datasets.py:457-541``),
- the OpenSLR-28 RIR corpus for the reverb augmentation
  (``src/transforms.py:255-268``) and MUSAN for noise mixing.

Everything is stdlib + :mod:`titanet_torch.utils.download` (urllib).
``source_url`` overrides exist on every fetch, so the tests run the whole
pipeline against local ``file://`` archives. m4a transcoding is a
pluggable hook: the default shells out to ffmpeg when present, since
decoding AAC in-process is out of scope (DIVERGENCES.md).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Sequence

from titanet_torch.utils.download import download_url_to_file, extract_archive

LIBRISPEECH_URL = "https://www.openslr.org/resources/12/{subset}.tar.gz"
VCTK_URL = (
    "https://datashare.ed.ac.uk/bitstream/handle/10283/3443/VCTK-Corpus-0.92.zip"
)
RIR_CORPORA_URL = "https://www.openslr.org/resources/28/rirs_noises.zip"
MUSAN_URL = "https://www.openslr.org/resources/17/musan.tar.gz"

# Multi-part VoxCeleb2 archive layout (reference _ARCHIVE_CONFIGS,
# src/datasets.py:415-434). URLs/credentials change over time, so they are
# parameters; these defaults mirror the reference's.
VOX2_USERNAME = "voxceleb1912"
VOX2_PASSWORD = "0s42xuw6"
VOX2_DEV_URLS = tuple(
    f"http://cnode01.mm.kaist.ac.kr/voxceleb/vox1a/vox2_dev_aac_part{p}"
    for p in ("aa", "ab", "ac", "ad", "ae", "af", "ag", "ah")
)
VOX2_TEST_URL = "http://cnode01.mm.kaist.ac.kr/voxceleb/vox1a/vox2_test_aac.zip"
VOX2_TEST_SHA256 = "e4d9200107a7bc60f0b620d5dc04c3aab66681b649f9c218380ac43c6c722079"

# VoxCeleb1 archives are already-wav (no m4a transcode step). The reference
# delegated to torchaudio's VoxCeleb1 downloader (src/datasets.py:373-377),
# which fetches these same multi-part dev archives + test zip.
VOX1_DEV_URLS = tuple(
    f"http://cnode01.mm.kaist.ac.kr/voxceleb/vox1a/vox1_dev_wav_part{p}"
    for p in ("aa", "ab", "ac", "ad")
)
VOX1_TEST_URL = "http://cnode01.mm.kaist.ac.kr/voxceleb/vox1a/vox1_test_wav.zip"


def fetch_librispeech(
    root: str,
    subset: str = "train-clean-100",
    source_url: Optional[str] = None,
    progress: bool = True,
) -> str:
    """Download + extract a LibriSpeech subset under ``root`` (reference
    auto-download path, src/datasets.py:303-306). Returns the corpus dir
    ``root/LibriSpeech/<subset>``."""
    target = os.path.join(root, "LibriSpeech", subset)
    if os.path.isdir(target):
        return target
    os.makedirs(root, exist_ok=True)
    url = source_url or LIBRISPEECH_URL.format(subset=subset)
    archive = os.path.join(root, os.path.basename(url.split("?")[0]))
    download_url_to_file(url, archive, progress=progress)
    extract_archive(archive, root)
    os.remove(archive)
    return target


def fetch_vctk(
    root: str, source_url: Optional[str] = None, progress: bool = True
) -> str:
    """Download + extract VCTK 0.92 under ``root`` (reference
    src/datasets.py:340-343). Returns ``root`` (audio lives under
    ``root/wav48_silence_trimmed``)."""
    audio_dir = os.path.join(root, "wav48_silence_trimmed")
    if os.path.isdir(audio_dir):
        return root
    os.makedirs(root, exist_ok=True)
    url = source_url or VCTK_URL
    archive = os.path.join(root, os.path.basename(url.split("?")[0]))
    download_url_to_file(url, archive, progress=progress)
    extract_archive(archive, root)
    os.remove(archive)
    return root


def fetch_rir_corpus(
    rir_corpora_path: str, source_url: Optional[str] = None, progress: bool = True
) -> str:
    """Download + extract the OpenSLR-28 "Room Impulse Response and Noise
    Database" (reference Reverb._download_rir_corpora,
    src/transforms.py:255-268). Returns ``rir_corpora_path``."""
    if list(Path(rir_corpora_path).rglob("*.wav")):
        return rir_corpora_path
    os.makedirs(rir_corpora_path, exist_ok=True)
    url = source_url or RIR_CORPORA_URL
    archive = os.path.join(rir_corpora_path, os.path.basename(url.split("?")[0]))
    download_url_to_file(url, archive, progress=progress)
    extract_archive(archive, rir_corpora_path)
    os.remove(archive)
    return rir_corpora_path


def fetch_musan(
    musan_path: str,
    source_url: Optional[str] = None,
    subset: Optional[str] = None,
    progress: bool = True,
) -> str:
    """Download + extract the MUSAN corpus (OpenSLR-17: music, speech and
    noise recordings — the standard additive-noise augmentation source for
    speaker systems; the reference has no noise augmentation at all).
    ``subset`` limits the returned glob root to ``musan/{noise|music|
    speech}``. Returns the directory to glob for wavs."""
    target = os.path.join(musan_path, "musan")
    sub = os.path.join(target, subset) if subset else target
    if list(Path(sub if os.path.isdir(sub) else target).rglob("*.wav")):
        return sub
    os.makedirs(musan_path, exist_ok=True)
    url = source_url or MUSAN_URL
    archive = os.path.join(musan_path, os.path.basename(url.split("?")[0]))
    download_url_to_file(url, archive, progress=progress)
    extract_archive(archive, musan_path)
    os.remove(archive)
    return sub


def _ffmpeg_transcode(src: str, dst: str, sample_rate: int) -> None:
    """Default m4a->wav transcoder: ffmpeg subprocess (the reference decoded
    AAC through librosa/audioread's own ffmpeg dependency,
    src/datasets.py:462-466)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            "no ffmpeg on PATH for m4a->wav conversion; pass transcode= to "
            "fetch_voxceleb2 (any callable (src, dst, sample_rate) -> None)"
        )
    subprocess.run(
        [ffmpeg, "-y", "-v", "error", "-i", src,
         "-ar", str(sample_rate), "-ac", "1", dst],
        check=True,
    )


def convert_m4a_tree(
    root: str,
    paths: Sequence[str],
    sample_rate: int = 16000,
    transcode: Optional[Callable[[str, str, int], None]] = None,
    n_jobs: int = 8,
) -> int:
    """Convert ``.m4a`` files to ``.wav`` in parallel threads and remove the
    originals (reference _convert_to_wav, src/datasets.py:457-477, which
    used joblib threading). Returns the number converted."""
    transcode = transcode or _ffmpeg_transcode
    m4a = [os.path.join(root, p) for p in paths if str(p).endswith(".m4a")]

    def one(path: str):
        dst = os.path.splitext(path)[0] + ".wav"
        try:
            transcode(path, dst, sample_rate)
        except Exception as exc:  # reference logged and continued
            print(f"[warn] could not convert {path}: {exc}")
        finally:
            if os.path.exists(path):
                os.remove(path)

    if m4a:
        with ThreadPoolExecutor(max_workers=max(n_jobs, 1)) as pool:
            list(pool.map(one, m4a))
    return len(m4a)


def reassemble_parts(part_paths: Sequence[str], out_path: str) -> str:
    """Concatenate split archive parts into one file (reference dev-split
    reassembly, src/datasets.py:495-509), streaming in chunks."""
    with open(out_path, "wb") as out:
        for part in part_paths:
            with open(part, "rb") as f:
                shutil.copyfileobj(f, out, 1 << 20)
    return out_path


def fetch_voxceleb1(
    root: str,
    dev_urls: Sequence[str] = VOX1_DEV_URLS,
    test_url: Optional[str] = VOX1_TEST_URL,
    test_sha256: Optional[str] = None,
    username: Optional[str] = VOX2_USERNAME,
    password: Optional[str] = VOX2_PASSWORD,
    progress: bool = True,
) -> str:
    """VoxCeleb1 acquisition (reference delegates to torchaudio's VoxCeleb1
    downloader when the root is missing, src/datasets.py:373-377): authed
    multi-part dev wav download -> zip reassembly -> extraction; test zip
    download with optional checksum. VoxCeleb1 ships wav (not m4a), so no
    transcode pass. Returns ``root/wav``."""
    wav_dir = os.path.join(root, "wav")
    if os.path.isdir(wav_dir):
        return wav_dir
    os.makedirs(root, exist_ok=True)

    archives = []
    if dev_urls:
        parts = []
        for url in dev_urls:
            part_path = os.path.join(root, os.path.basename(url.split("?")[0]))
            download_url_to_file(
                url, part_path, username=username, password=password,
                progress=progress,
            )
            parts.append(part_path)
        dev_zip = os.path.join(root, "vox1_dev_wav.zip")
        reassemble_parts(parts, dev_zip)
        for part in parts:
            os.remove(part)
        archives.append(dev_zip)
    if test_url:
        test_zip = os.path.join(root, os.path.basename(test_url.split("?")[0]))
        download_url_to_file(
            test_url, test_zip, username=username, password=password,
            hash_prefix=test_sha256, progress=progress,
        )
        archives.append(test_zip)

    for archive in archives:
        extract_archive(archive, root)
        os.remove(archive)
    return wav_dir


def fetch_voxceleb2(
    root: str,
    dev_urls: Sequence[str] = VOX2_DEV_URLS,
    test_url: Optional[str] = VOX2_TEST_URL,
    test_sha256: Optional[str] = VOX2_TEST_SHA256,
    username: Optional[str] = VOX2_USERNAME,
    password: Optional[str] = VOX2_PASSWORD,
    sample_rate: int = 16000,
    transcode: Optional[Callable[[str, str, int], None]] = None,
    progress: bool = True,
) -> str:
    """Full VoxCeleb2 acquisition (reference _download_extract_wavs,
    src/datasets.py:479-541): authed multi-part dev download -> zip
    reassembly -> extraction; test zip download with checksum; parallel
    m4a->wav conversion; ``aac/`` moved to ``wav/``. Returns ``root/wav``."""
    wav_dir = os.path.join(root, "wav")
    if os.path.isdir(wav_dir):
        return wav_dir
    os.makedirs(root, exist_ok=True)

    archives = []
    if dev_urls:
        parts = []
        for url in dev_urls:
            part_path = os.path.join(root, os.path.basename(url.split("?")[0]))
            download_url_to_file(
                url, part_path, username=username, password=password,
                progress=progress,
            )
            parts.append(part_path)
        dev_zip = os.path.join(root, "vox2_dev_aac.zip")
        reassemble_parts(parts, dev_zip)
        for part in parts:
            os.remove(part)
        archives.append(dev_zip)
    if test_url:
        test_zip = os.path.join(root, os.path.basename(test_url.split("?")[0]))
        download_url_to_file(
            test_url, test_zip, username=username, password=password,
            hash_prefix=test_sha256, progress=progress,
        )
        archives.append(test_zip)

    for archive in archives:
        extract_archive(archive, root)
        os.remove(archive)
    converted = [
        str(p.relative_to(root)) for p in Path(root).rglob("*.m4a")
    ]
    convert_m4a_tree(root, converted, sample_rate=sample_rate, transcode=transcode)
    aac_dir = os.path.join(root, "aac")
    if os.path.isdir(aac_dir):
        shutil.move(aac_dir, wav_dir)
    return wav_dir
