"""8-bit RGB PNG files without Pillow: ``encode`` (no filtering) and
``decode`` (any of the five scanline filters, no interlace), numpy only."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes of an 8-bit RGB image -> uint8 [H, W, 3]."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, color, interlace) != (8, 2, 0):
                raise ValueError(f"PNG depth {depth}, colour type {color}, interlace "
                                 f"{interlace}: only 8-bit RGB without interlace is read")
        elif kind == b"IDAT":
            idat += body
    if w is None:
        raise ValueError("PNG without IHDR")
    stride, bpp = w * 3, 3
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prior) & 255
        elif ftype in (1, 3, 4):  # each byte depends on its left neighbour
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prior[i]) // 2
                else:
                    pred = int(_paeth(a, prior[i], prior[i - bpp] if i >= bpp else 0))
                cur[i] = (line[i] + pred) & 255
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y], prior = cur, cur
    return out.astype(np.uint8).reshape(h, w, 3)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 (clamped, rounded half up), as frames are saved."""
    arr = np.asarray(image, dtype=np.float32)
    return (np.clip((arr + 1.0) / 2.0, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
