"""Host-side audio decoding.

The reference delegated decoding to torchaudio/libsndfile/ffmpeg (its
``src/datasets.py``, SURVEY.md §2.2). The port depends on none of them, so
decoding is first-party:

- WAV: pure numpy parser (PCM 8/16/24/32-bit and float32/64),
- FLAC: the repo's C++ decoder (``native/audioio.cpp``) loaded via ctypes —
  see :mod:`titanet_torch.data.native`, which compiles it into
  ``titanet_torch/_build/`` at first use — with clear errors when it cannot.

The port's own copy of ``titanet_tpu/data/audio_io.py``: the same parser,
so a file decodes to the same samples in both packages.

Decoders return ``(waveform float32 [channels, samples], sample_rate)``
matching torchaudio.load conventions (normalized to [-1, 1]).
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM/float WAV file -> (float32 [C, T] in [-1, 1], rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) >= 24:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1  # assume PCM subformat
    if audio_format == 1:  # PCM
        if bits == 8:
            x = np.frombuffer(payload, np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(payload, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    if channels > 1:
        x = x.reshape(-1, channels).T
    else:
        x = x[None, :]
    return np.ascontiguousarray(x), rate


def write_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write float32 [C, T] (or [T]) to 16-bit PCM WAV (test fixtures)."""
    x = np.asarray(waveform, np.float32)
    if x.ndim == 1:
        x = x[None]
    pcm = np.clip(np.round(x.T * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode FLAC via the native C++ decoder."""
    from titanet_torch.data import native

    return native.read_flac(path)


_EXT_READERS = {".wav": read_wav, ".flac": read_flac}


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    import os

    ext = os.path.splitext(path)[1].lower()
    if ext not in _EXT_READERS:
        raise ValueError(f"Unsupported audio extension {ext!r} for {path}")
    return _EXT_READERS[ext](path)


def read_mono(path: str, sample_rate: int) -> np.ndarray:
    """Decode a wav/flac file to a mono f32 waveform ``[T]`` at
    ``sample_rate``: ``[C, T]`` downmixed as the loader does, resampled when
    the file's rate differs."""
    from titanet_torch.data.loader import _resample_host

    wav, sr = read_audio(path)
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    wav = wav.reshape(-1)
    if sr != sample_rate:
        wav = _resample_host(wav, sr, sample_rate)
    return wav
