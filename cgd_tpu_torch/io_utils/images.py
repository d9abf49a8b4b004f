"""Frame persistence with the JAX package's output-tree contract
(``cgd_tpu/io_utils/images.py``): outputs/<prompt-slug>/<batch:02>/<step:04>.png
plus a ``current.png`` in the working directory at every save. The PNG
encoder uses only ``zlib`` and ``struct`` (no Pillow)."""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List

import numpy as np


def alphanumeric_filter(s: str) -> str:
    return re.sub(r"[^\w\s]", "", s).replace(" ", "_")


def clean_and_combine_prompts(base_path, txts: List[str], batch_idx: int, max_length: int = 255) -> str:
    slug = "_".join(alphanumeric_filter(t) for t in txts)[:max_length]
    return os.path.join(str(base_path), slug, f"{batch_idx:02}")


def to_uint8(image_hwc: np.ndarray) -> np.ndarray:
    """[-1,1] float HWC -> uint8 HWC (clamped, rounded)."""
    arr = np.asarray(image_hwc, dtype=np.float32)
    return (np.clip((arr + 1.0) / 2.0, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, no filtering)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"encode_png takes RGB images, got {c} channels")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def log_image(image_hwc: np.ndarray, base_path, txts: List[str], current_step: int,
              batch_idx: int) -> str:
    """Save a frame and current.png; returns the frame's path."""
    dirname = clean_and_combine_prompts(base_path, txts, batch_idx)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(dirname, f"{current_step:04}.png")
    data = encode_png(to_uint8(image_hwc))
    _write(os.path.join(os.getcwd(), "current.png"), data)
    _write(filename, data)
    return str(filename)
