"""Checkpoint download and cache, a copy of ``cgd_tpu/io_utils/download.py``
with the same behaviour: the reference's cache layout
(~/.cache/clip-guided-diffusion, clip/ subdirectory), three tries with
exponential backoff, a tmp file, a size check against Content-Length, fsync
and an atomic rename, and an existing file reused as it is. urllib only.
"""

from __future__ import annotations

import os
import time
import urllib.request
from pathlib import Path

CACHE_PATH = os.path.expanduser("~/.cache/clip-guided-diffusion")


class DownloadError(RuntimeError):
    pass


def download(url: str, filename: str, root: str = CACHE_PATH, max_retries: int = 3) -> str:
    os.makedirs(root, exist_ok=True)
    target = Path(root) / filename
    tmp = target.with_suffix(".tmp")
    if target.exists() and not target.is_file():
        raise DownloadError(f"{target} exists and is not a regular file")
    if target.is_file():
        return str(target)

    last_err = None
    for attempt in range(max_retries):
        try:
            req = urllib.request.Request(url, headers={"User-Agent": "cgd-tpu/0.1"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                total = int(resp.headers.get("Content-Length", 0) or 0)
                with open(tmp, "wb") as out:
                    while True:
                        chunk = resp.read(1 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
                    out.flush()
                    os.fsync(out.fileno())
            if total and tmp.stat().st_size != total:
                raise DownloadError(
                    f"incomplete download: expected {total}, got {tmp.stat().st_size}"
                )
            os.rename(tmp, target)
            return str(target)
        except Exception as e:  # noqa: BLE001 — retry any transport failure
            last_err = e
            if tmp.exists():
                tmp.unlink()
            if attempt < max_retries - 1:
                time.sleep(2**attempt)
    raise DownloadError(f"download failed after {max_retries} attempts: {last_err}")


def fetch(url_or_path):
    """An open binary file for a local path, or the bytes of an http(s) URL
    (the reference's ``fetch``)."""
    import io

    s = str(url_or_path)
    if s.startswith("http://") or s.startswith("https://"):
        req = urllib.request.Request(s, headers={"User-Agent": "cgd-tpu/0.1"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return io.BytesIO(resp.read())
    return open(s, "rb")
