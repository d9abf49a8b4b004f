"""Separable image resampling equal to the reference's vendored ResizeRight
for full output shapes: a copy of ``cgd_tpu/ops/resample.py`` (pinned to it
and to tests/goldens/resize_right.npz by tests/test_torch_port_images.py).

The weights of each resized dim are one dense [out, in] matrix built on the
host in float64 numpy (``_resize_matrix``, copied as it is) and applied
with ``torch.tensordot``, in ResizeRight's ascending-scale dim order.
Zero padding (ResizeRight's 'constant' pad mode) is folded into the matrix.
A partial ``out_shape`` replaces the leading dims and keeps the rest:
``resize(arr, (smallest,))`` resizes H only, as the image-prompt path of
both packages does.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def _lanczos3(x):
    return (
        (np.sin(np.pi * x) * np.sin(np.pi * x / 3) + _EPS)
        / ((np.pi**2 * x**2 / 3) + _EPS)
    ) * (np.abs(x) < 3)


def _lanczos2(x):
    return (
        (np.sin(np.pi * x) * np.sin(np.pi * x / 2) + _EPS)
        / ((np.pi**2 * x**2 / 2) + _EPS)
    ) * (np.abs(x) < 2)


def _cubic(x):
    absx = np.abs(x)
    absx2 = absx**2
    absx3 = absx**3
    return (1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1.0) + (
        -0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0
    ) * ((1.0 < absx) & (absx <= 2.0))


def _linear(x):
    return (x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1))


def _box(x):
    return ((-1 <= x) & (x < 0)) + 1.0 * ((0 <= x) & (x <= 1))


_KERNELS = {
    "lanczos3": (_lanczos3, 6.0),
    "lanczos2": (_lanczos2, 4.0),
    "cubic": (_cubic, 4.0),
    "linear": (_linear, 2.0),
    "box": (_box, 1.0),
}


@lru_cache(maxsize=64)
def _resize_matrix(in_sz: int, out_sz: int, method: str, antialias: bool) -> np.ndarray:
    """Dense [out_sz, in_sz] float32 row-normalized resampling matrix."""
    kernel, support = _KERNELS[method]
    scale = out_sz / in_sz
    if antialias and scale < 1.0:
        kern = lambda x: scale * kernel(scale * x)
        support = support / scale
    else:
        kern = kernel

    grid = np.arange(out_sz, dtype=np.float64) / scale + (in_sz - 1) / 2 - (
        out_sz - 1
    ) / (2 * scale)
    left = np.ceil(grid - support / 2 - _EPS).astype(np.int64)
    taps = int(math.ceil(support - _EPS))
    fov = left[:, None] + np.arange(taps)[None, :]  # [out, taps]
    w = kern(grid[:, None] - fov)
    s = w.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    w = w / s

    mat = np.zeros((out_sz, in_sz), np.float64)
    rows = np.repeat(np.arange(out_sz), taps)
    cols = fov.reshape(-1)
    ok = (cols >= 0) & (cols < in_sz)  # constant (zero) padding: drop taps
    np.add.at(mat, (rows[ok], cols[ok]), w.reshape(-1)[ok])
    return mat.astype(np.float32)


def resize(
    image: torch.Tensor,
    out_shape: Sequence[int],
    method: str = "lanczos3",
    antialias: bool = True,
) -> torch.Tensor:
    """Resize the leading ``len(out_shape)`` dims of ``image`` (f32) to
    ``out_shape``: one [out, in] matrix product per resized dim, in
    ascending scale order (ResizeRight's dim loop)."""
    in_shape = tuple(image.shape)
    full = tuple(int(s) for s in out_shape) + in_shape[len(out_shape):]
    dims = [d for d in range(len(full)) if full[d] != in_shape[d]]
    dims.sort(key=lambda d: full[d] / in_shape[d])
    x = image
    for d in dims:
        mat = torch.from_numpy(_resize_matrix(in_shape[d], full[d], method, antialias)).to(x.device)
        x = torch.movedim(torch.tensordot(mat, x, dims=([1], [d])), 0, d)
    return x
