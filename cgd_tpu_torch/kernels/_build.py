"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built at first use from the sources in ``cgd_tpu_torch/csrc``
into ``build/cgd_tpu_torch/`` at the repository root (listed in
``.gitignore``), under a file name keyed by the sources' content, so an
edited source rebuilds and an unchanged one loads the cached library.
Nothing here runs at import time: the CPU-only test environment has no
``nvcc``.
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
from typing import Optional

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cgd_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last nvcc run, None if cached


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of cgd_tpu_torch are built from source at first use"
        )
    return found


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cgd_conv3x3_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.cgd_conv3x3_fwd.restype = i
    lib.cgd_conv3x3_dx.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.cgd_conv3x3_dx.restype = i
    lib.cgd_conv3x3_dx_chunks.argtypes = [i, i, i]
    lib.cgd_conv3x3_dx_chunks.restype = i
    lib.cgd_conv3x3_tile_m.argtypes = []
    lib.cgd_conv3x3_tile_m.restype = i
    lib.cgd_error_string.argtypes = [i]
    lib.cgd_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = hashlib.sha256()
        for src in srcs:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        digest.update(" ".join(_NVCC_FLAGS).encode())
        so = _BUILD_DIR / f"libcgd_kernels_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                   *(str(s) for s in srcs if s.suffix == ".cu")]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}\n{res.stderr}"
                )
            build_seconds = time.perf_counter() - t0
            os.replace(tmp, so)
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry point."""
    if status != 0:
        msg = library().cgd_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError_t {status} ({msg})")
