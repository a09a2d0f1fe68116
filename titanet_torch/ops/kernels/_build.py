"""Build the CUDA sources in ``titanet_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled at first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``<build dir>/lib<name>-<digest>.so`` and loaded with ``ctypes``. The digest
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edit rebuilds, and the same sources find a library that another process or
checkout built into the same directory. The build directory is
``titanet_torch/_build`` (git-ignored) unless :func:`set_build_dir` names
another (:func:`titanet_torch.utils.enable_compilation_cache` does). No
PyTorch header is compiled, so a build takes seconds.

Every C entry point returns ``cudaGetLastError()`` after its launches, and
its Python wrapper raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"  # set_build_dir() changes it for the process
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("logmel", "attn_pool", "dw_bwd", "megablock", "mel_frames")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's standard install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def set_build_dir(path) -> Path:
    """Build and look up the libraries in ``path`` (created if missing)
    from now on; libraries already loaded stay loaded. Returns the
    directory."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def library_path(name: str) -> Tuple[Path, Path]:
    """(source, shared-library path) of kernel source ``name``."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns ``{name: (seconds, compiler log)}`` for
    the sources it compiled; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, time.perf_counter(),
        )
    done, failed = {}, []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        done[name] = (seconds, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)[1]))
        return _libs[name]
