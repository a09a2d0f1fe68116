"""Download utilities (port of ``titanet_tpu/utils/download.py``; reference
download_auth_url_to_file, ``src/utils.py:471-505``): streamed HTTP(S)
download with optional basic auth and sha256-prefix verification,
stdlib-only (urllib), and archive extraction.

The tests drive them against local ``file://`` URLs; the API is what
corpus fetching (:mod:`titanet_torch.data.acquire`, e.g. VoxCeleb2's
multi-part archives) needs.
"""

from __future__ import annotations

import base64
import hashlib
import os
import shutil
import urllib.request
from typing import Optional


def download_url_to_file(
    url: str,
    file_path: str,
    username: Optional[str] = None,
    password: Optional[str] = None,
    hash_prefix: Optional[str] = None,
    chunk_size: int = 1 << 20,
    progress: bool = False,
) -> bool:
    """Stream ``url`` to ``file_path``; verify sha256 prefix if given."""
    request = urllib.request.Request(url)
    if username is not None:
        token = base64.b64encode(f"{username}:{password or ''}".encode()).decode()
        request.add_header("Authorization", f"Basic {token}")
    sha256 = hashlib.sha256() if hash_prefix is not None else None
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    with urllib.request.urlopen(request) as response, open(file_path, "wb") as out:
        total = int(response.headers.get("content-length") or 0)
        done = 0
        while True:
            buf = response.read(chunk_size)
            if not buf:
                break
            out.write(buf)
            if sha256 is not None:
                sha256.update(buf)
            done += len(buf)
            if progress and total:
                print(f"\r{done / total:6.1%} of {url}", end="", flush=True)
        if progress and total:
            print()
    if sha256 is not None:
        digest = sha256.hexdigest()
        if digest[: len(hash_prefix)] != hash_prefix:
            os.remove(file_path)
            raise RuntimeError(
                f'invalid hash value (expected "{hash_prefix}", got "{digest}")'
            )
    return True


def extract_archive(path: str, dest: Optional[str] = None) -> str:
    """Unpack zip/tar archives (reference used torchaudio's extract_archive).
    Tar members are sanitized with the "data" filter (no absolute paths,
    no traversal)."""
    dest = dest or os.path.dirname(os.path.abspath(path))
    if any(path.endswith(s) for s in (".tar", ".tar.gz", ".tgz", ".tar.bz2")):
        import tarfile

        with tarfile.open(path) as tar:
            tar.extractall(dest, filter="data")
        return dest
    shutil.unpack_archive(path, dest)
    return dest
