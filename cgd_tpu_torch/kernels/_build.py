"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built at first use from the sources in ``cgd_tpu_torch/csrc``
into ``build/cgd_tpu_torch/`` at the repository root (listed in
``.gitignore``), under a file name keyed by the sources' content, so an
edited source rebuilds and an unchanged one loads the cached library. Each
``.cu`` compiles in its own nvcc process, all started together, and one more
links the objects. Nothing here runs at import time: the CPU-only test
environment has no ``nvcc``.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and wgmma serialization per kernel: ptxas_log()
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_so: Optional[Path] = None
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
    lib.cgd_conv3x3_fwd.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.cgd_conv3x3_fwd.restype = i
    lib.cgd_conv3x3_dx.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.cgd_conv3x3_dx.restype = i
    lib.cgd_conv3x3_dx_chunks.argtypes = [i, i, i, i]
    lib.cgd_conv3x3_dx_chunks.restype = i
    lib.cgd_conv3x3_smem_bytes.argtypes = [i, i]
    lib.cgd_conv3x3_smem_bytes.restype = i
    lib.cgd_conv3x3_encode_seconds.argtypes = [p, i]
    lib.cgd_conv3x3_encode_seconds.restype = ctypes.c_double
    lib.cgd_conv3x3_f32.argtypes = [p] * 11 + [i] * 9 + [p]
    lib.cgd_conv3x3_f32.restype = i
    lib.cgd_conv3x3_dx_f32.argtypes = [p] * 11 + [i] * 8 + [p]
    lib.cgd_conv3x3_dx_f32.restype = i
    lib.cgd_conv3x3_f32_split.argtypes = [p, p, i, i, p]
    lib.cgd_conv3x3_f32_split.restype = i
    lib.cgd_conv3x3_f32_plan.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.cgd_conv3x3_f32_plan.restype = i
    lib.cgd_attn_fwd.argtypes = [p] * 3 + [i] * 8 + [p]
    lib.cgd_attn_fwd.restype = i
    lib.cgd_attn_bwd.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.cgd_attn_bwd.restype = i
    lib.cgd_attn_smem_bytes.argtypes = [i, i]
    lib.cgd_attn_smem_bytes.restype = i
    lib.cgd_attn_fwd_f32.argtypes = [p] * 3 + [i] * 8 + [p]
    lib.cgd_attn_fwd_f32.restype = i
    lib.cgd_attn_bwd_f32.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.cgd_attn_bwd_f32.restype = i
    lib.cgd_attn_f32_smem_bytes.argtypes = [i, i]
    lib.cgd_attn_f32_smem_bytes.restype = i
    lib.cgd_warp_bwd.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.cgd_warp_bwd.restype = i
    lib.cgd_warp_index_count.argtypes = [p] * 4 + [i] * 2 + [p]
    lib.cgd_warp_index_count.restype = i
    lib.cgd_warp_index_sort.argtypes = [p] * 7 + [i] + [p]
    lib.cgd_warp_index_sort.restype = i
    lib.cgd_warp_index_long.argtypes = [p] * 4 + [i] * 2 + [p]
    lib.cgd_warp_index_long.restype = i
    lib.cgd_warp_index_long_blocks.argtypes = [i]
    lib.cgd_warp_index_long_blocks.restype = i
    lib.cgd_error_string.argtypes = [i]
    lib.cgd_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, _so, build_seconds
    if _lib is not None:  # every launch asks: no lock once loaded
        return _lib
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
            nvcc = _nvcc()
            t0 = time.perf_counter()
            objs, jobs = [], []
            for src in (s for s in srcs if s.suffix == ".cu"):
                obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
                cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
                objs.append(obj)
            outputs = [proc.communicate()[0] for _, proc in jobs]  # wait for all
            for (cmd, proc), out in zip(jobs, outputs):
                _check_nvcc(cmd, proc.returncode, out)
            so.with_suffix(".ptxas.log").write_text("".join(outputs))
            link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(link, capture_output=True, text=True)
            _check_nvcc(link, res.returncode, res.stdout + res.stderr)
            for obj in objs:
                obj.unlink()
            build_seconds = time.perf_counter() - t0
            os.replace(tmp, so)
        _lib = _declare(ctypes.CDLL(str(so)))
        _so = so
        return _lib


def ptxas_log() -> str:
    """What ptxas said (-v) when the loaded library was built: per kernel
    its registers, spill stores / loads and shared memory, and any warning
    that it serializes wgmmas (C7512: too few registers; C7513: an A
    fragment written while a wgmma that reads it may be in flight)."""
    library()
    log = _so.with_suffix(".ptxas.log")
    return log.read_text() if log.exists() else ""


def _check_nvcc(cmd, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{output}")


def stream(dev) -> int:
    """The handle of PyTorch's current CUDA stream on ``dev`` (a CUDA
    device with its index): every kernel launches there and does not
    synchronise."""
    import torch

    return torch._C._cuda_getCurrentRawStream(dev.index)


# the conv entry points return this plus the CUresult of a failed
# cuTensorMapEncodeTiled (csrc/conv3x3_common.cuh ENCODE_ERROR)
ENCODE_ERROR = 100000


def check(status: int, what: str) -> None:
    """Raise on a nonzero status returned by a kernel's C entry point: a
    cudaError_t, or ENCODE_ERROR + the CUresult of a failed tensor-map
    encode."""
    if status >= ENCODE_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed: CUresult "
                           f"{status - ENCODE_ERROR}")
    if status != 0:
        msg = library().cgd_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError_t {status} ({msg})")
