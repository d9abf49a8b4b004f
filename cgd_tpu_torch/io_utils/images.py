"""Image files, counterpart of ``cgd_tpu/io_utils/images.py``.

Frames follow the JAX package's output-tree contract:
outputs/<prompt-slug>/<batch:02>/<step:04>.png plus a ``current.png`` in the
working directory at every save. Init and prompt images are read by
``decode_image`` and ``load_image_rgb``. Both directions work without
Pillow, over ``zlib`` and ``struct``: the encoder writes 8-bit RGB, the
decoder reads 8-bit gray, gray+alpha, RGB, RGBA and palette PNGs,
non-interlaced, with every filter type. Other files (JPEG, 16-bit or
interlaced PNGs, ...) go through Pillow when it is installed and raise
``UnsupportedImage`` naming the format otherwise. ``resize_like_pillow`` is
Pillow's default ``Image.resize`` filter on 8-bit RGB (BICUBIC, a = -0.5,
support stretched by the downscale factor, fixed-point coefficients, two
separable passes that each round to uint8), the resize the JAX package's
``load_image_rgb`` applies.
"""

from __future__ import annotations

import io
import os
import queue
import re
import struct
import threading
import zlib
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from cgd_tpu_torch.utils import tracing


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


def _write_frame(data: bytes, paths) -> None:
    for path in paths:
        _write(path, data)


class _FrameWriter:
    """One background thread that encodes and writes frames in the order
    they were submitted (``current.png`` ends as the last frame, as with
    synchronous writes); ``zlib.compress`` releases the GIL, so the
    sampling thread goes on meanwhile. The counterpart of the JAX package's
    native writer (``cgd_tpu/io_utils/native_frameio.py``): a write that
    fails is counted, not raised."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = None
        self._lock = threading.Lock()
        self._errors = 0

    def submit(self, rgb: np.ndarray, paths) -> None:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="cgd-frame-writer",
                                                daemon=True)
                self._thread.start()
        self._queue.put((rgb, tuple(paths)))

    def _run(self) -> None:
        while True:
            rgb, paths = self._queue.get()
            try:
                _write_frame(encode_png(rgb), paths)
            except Exception:
                with self._lock:
                    self._errors += 1
            finally:
                self._queue.task_done()

    def flush(self) -> int:
        """Wait for every submitted frame; returns the writes that failed
        since the last flush."""
        self._queue.join()
        with self._lock:
            errors, self._errors = self._errors, 0
        return errors


_WRITER = _FrameWriter()


def log_image(image_hwc: np.ndarray, base_path, txts: List[str], current_step: int,
              batch_idx: int, use_async: bool = False) -> str:
    """Save a frame and current.png; returns the frame's path. With
    ``use_async`` the PNG is encoded and written on a background thread:
    call ``flush_frames()`` before reading the files."""
    with tracing.span("images.write", k=current_step) as sp:
        dirname = clean_and_combine_prompts(base_path, txts, batch_idx)
        os.makedirs(dirname, exist_ok=True)
        filename = os.path.join(dirname, f"{current_step:04}.png")
        paths = (os.path.join(os.getcwd(), "current.png"), filename)
        rgb = to_uint8(image_hwc)
        if use_async:
            _WRITER.submit(rgb, paths)
            sp.note(queued=rgb.nbytes)
        else:
            data = encode_png(rgb)
            _write_frame(data, paths)
            sp.note(bytes=len(data) * len(paths))
    return str(filename)


def flush_frames() -> int:
    """Block until every asynchronous frame write has ended; returns how
    many failed since the last flush."""
    return _WRITER.flush()


# ---------------------------------------------------------------------------
# reading images
# ---------------------------------------------------------------------------

class UnsupportedImage(ValueError):
    """An image file the decoder without Pillow does not read."""


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_KINDS = {0: ("gray", 1), 2: ("RGB", 3), 3: ("palette", 1), 4: ("gray+alpha", 2),
              6: ("RGBA", 4)}  # colour type -> (name, samples per pixel)


def _unfilter_sequential(ftype: int, line: bytearray, prior: bytes, bpp: int) -> bytearray:
    """Undo the average (3) or Paeth (4) filter of one scanline in place."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF
    return line


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (gray, gray+alpha, RGB, RGBA or palette)
    -> uint8 [H, W, 3] RGB, as Pillow's ``convert("RGB")`` gives it: gray
    replicated, alpha dropped, palette indices looked up. Raises
    ``UnsupportedImage`` for any other file."""
    if not data.startswith(_PNG_SIGNATURE):
        raise UnsupportedImage("not a PNG file")
    pos, hdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"broken PNG file: bad CRC in its {kind.decode(errors='replace')} chunk")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("broken PNG file: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    name = _PNG_KINDS.get(ctype, (f"colour type {ctype}", 0))[0]
    if depth != 8 or interlace or ctype not in _PNG_KINDS:
        raise UnsupportedImage(f"PNG, {depth}-bit {name}{', interlaced' if interlace else ''}")
    if ctype == 3 and palette is None:
        raise ValueError("broken PNG file: palette image without a PLTE chunk")
    bpp = _PNG_KINDS[ctype][1]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("broken PNG file: image data too short")
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            recon = line
        elif ftype == 1:  # sub: a running sum per channel, modulo 256
            recon = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # up
            recon = line + prior
        elif ftype in (3, 4):
            recon = np.frombuffer(_unfilter_sequential(ftype, bytearray(line.tobytes()),
                                                       prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"broken PNG file: filter type {ftype}")
        out[y] = recon
        prior = out[y]
    px = out.reshape(height, width, bpp)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def decode_image(path_or_url) -> np.ndarray:
    """A local path or URL -> uint8 [H, W, 3] RGB (Pillow's
    ``Image.open(...).convert("RGB")``): PNGs of the kinds ``decode_png``
    reads without Pillow, anything else through Pillow."""
    from cgd_tpu_torch.io_utils.download import fetch

    with fetch(path_or_url) as f:
        data = f.read()
    try:
        return decode_png(data)
    except UnsupportedImage as e:
        try:
            from PIL import Image
        except ImportError:
            raise UnsupportedImage(
                f"{path_or_url}: {e}; only 8-bit non-interlaced PNGs are read "
                "without Pillow") from None
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _bicubic(x: float) -> float:
    """Pillow's bicubic filter, a = -0.5 (libImaging/Resample.c)."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


@lru_cache(maxsize=16)
def _pillow_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bicubic filter over the whole input, as a dense [out, in] matrix of the
    integer fixed-point coefficients (float64, exact)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            fixed = w * (1 << _PRECISION_BITS)
            mat[xx, xmin + x] = int(fixed - 0.5) if w < 0 else int(fixed + 0.5)
    return mat


def _pillow_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit resampling pass along ``axis`` (0: rows, 1: columns),
    rounding to uint8 as Pillow does: (sum + 2^21) >> 22, clipped."""
    mat = _pillow_matrix(img.shape[axis], out_size)
    acc = np.moveaxis(np.tensordot(mat, img.astype(np.float64), axes=([1], [axis])), 0, axis)
    acc = np.floor((acc + (1 << (_PRECISION_BITS - 1))) / (1 << _PRECISION_BITS))
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_like_pillow(rgb: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [h, w, C] for ``size`` = (w, h): Pillow's
    ``Image.resize(size)`` with its default filter on an RGB image, the
    horizontal pass first."""
    w, h = size
    out = rgb
    if w != rgb.shape[1]:
        out = _pillow_pass(out, 1, w)
    if h != rgb.shape[0]:
        out = _pillow_pass(out, 0, h)
    return out


def load_image_rgb(path_or_url, size) -> np.ndarray:
    """A local path or URL as RGB, resized to (size, size), or to (w, h) when
    ``size`` is a tuple -> [-1, 1] float32 HWC (the reference's init-image
    handling, cgd/cgd.py:116-120)."""
    wh = (size, size) if isinstance(size, int) else tuple(size)
    arr = np.asarray(resize_like_pillow(decode_image(path_or_url), wh), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0
