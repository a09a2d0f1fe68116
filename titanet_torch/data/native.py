"""ctypes binding to the repo's C++ FLAC decoder (``native/audioio.cpp``).

The port compiles its own copy of the library at first use, with the C++
compiler named by ``$CXX`` (default ``g++``), into
``titanet_torch/_build/libaudioio-<digest>.so`` (git-ignored; the digest
covers the source, so an edit rebuilds). It never writes under ``native/``,
whose ``Makefile`` belongs to the JAX package. Raises a clear error when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "audioio.cpp"
BUILD_DIR = _REPO_ROOT / "titanet_torch" / "_build"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libaudioio-{digest}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} exited {proc.returncode}: {proc.stderr}")
    os.replace(tmp, lib)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            try:
                _build(path)
            except Exception as e:
                raise RuntimeError(
                    f"the FLAC decoder {SOURCE} could not be compiled: {e}. "
                    "Set CXX to a C++17 compiler."
                ) from e
        lib = ctypes.CDLL(str(path))
        lib.audioio_decode_flac.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.audioio_decode_flac.restype = ctypes.c_int
        lib.audioio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.audioio_free.restype = None
        _lib = lib
        return lib


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode FLAC -> (float32 [C, T], sample_rate)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    rc = lib.audioio_decode_flac(
        str(path).encode(), ctypes.byref(out), ctypes.byref(n_frames),
        ctypes.byref(channels), ctypes.byref(rate),
    )
    if rc != 0:
        raise ValueError(f"FLAC decode failed for {path} (rc={rc})")
    try:
        n = n_frames.value * channels.value
        flat = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.audioio_free(out)
    wav = flat.reshape(n_frames.value, channels.value).T
    return np.ascontiguousarray(wav), rate.value
