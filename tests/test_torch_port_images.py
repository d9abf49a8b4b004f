"""The port's image inputs against cgd_tpu and Pillow, on the CPU:
- ``ops.resample.resize`` (a copy of cgd_tpu's, its matrices pinned) against
  cgd_tpu's and the ResizeRight goldens (tests/goldens/resize_right.npz),
  atol 2e-6 as tests/test_resample.py;
- the PNG decoder without Pillow against Pillow's ``convert("RGB")`` on every
  colour type it reads and every filter type, exactly; other formats through
  Pillow, or an error naming the format without it;
- Pillow's default resize filter on 8-bit RGB, and ``load_image_rgb``
  against cgd_tpu's, within 1 LSB (2/255 in [-1, 1]; equal in practice);
- ``q_sample`` and the image-prompt path (decode, lanczos3 resize of the
  first dim, cutouts at injected coordinates, CLIP) in both parity modes,
  against cgd_tpu at f32 (rtol 1e-5 / 1e-4 x max: f32 sums in other orders).
"""

import dataclasses
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu import api as japi  # noqa: E402
from cgd_tpu.diffusion import gaussian as jgauss  # noqa: E402
from cgd_tpu.guidance.cutouts import CutoutSpec as JSpec  # noqa: E402
from cgd_tpu.io_utils import images as jimages  # noqa: E402
from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu.ops import resample as jresample  # noqa: E402
from cgd_tpu_torch import api as tapi  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.diffusion import gaussian as tgauss  # noqa: E402
from cgd_tpu_torch.guidance.cutouts import CutoutSpec as TSpec  # noqa: E402
from cgd_tpu_torch.io_utils import images as timages  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402
from cgd_tpu_torch.ops import resample as tresample  # noqa: E402

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "resize_right.npz")


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def test_resize_matches_the_resizeright_goldens():
    g = np.load(GOLDENS)
    names = sorted({k.rsplit("__", 1)[0] for k in g.files})
    assert len(names) >= 7
    for n in names:
        img, ref = g[f"{n}__in"], g[f"{n}__out"]
        ours = tresample.resize(torch.from_numpy(img), ref.shape[:2], method=str(g[f"{n}__method"]))
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-6, err_msg=n)


@pytest.mark.parametrize("in_shape,out_shape,method", [
    ((48, 40, 3), (32, 24), "lanczos3"), ((37, 53, 3), (29, 41), "lanczos2"),
    ((20, 30, 3), (45, 12), "cubic"), ((16, 16, 3), (8, 24), "linear"),
    ((12, 18, 3), (6, 9), "box"), ((48, 40, 3), (24,), "lanczos3"),
    ((50, 70, 3), (50, 70), "lanczos3"),
])
def test_resize_matches_cgd_tpu(in_shape, out_shape, method):
    img = np.random.RandomState(1).rand(*in_shape).astype(np.float32)
    ours = tresample.resize(torch.from_numpy(img), out_shape, method=method).numpy()
    ref = np.asarray(jresample.resize(jnp.asarray(img), out_shape, method=method))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=2e-6)
    for i, o in zip(in_shape, out_shape):
        np.testing.assert_array_equal(tresample._resize_matrix(i, o, method, True),
                                      jresample._resize_matrix(i, o, method, True))


# ---------------------------------------------------------------------------
# PNG decoding
# ---------------------------------------------------------------------------

def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(px, filters):
    """The scanlines of ``px`` [H, W, samples] uint8, row y under filter
    ``filters[y % len(filters)]`` (the forward filters of the PNG spec)."""
    h, w, bpp = px.shape
    raw, prior = b"", [0] * (w * bpp)
    for y in range(h):
        line, f = px[y].reshape(-1).astype(int).tolist(), filters[y % len(filters)]
        out = []
        for i, v in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b, c = prior[i], prior[i - bpp] if i >= bpp else 0
            out.append((v - [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]) & 0xFF)
        raw += bytes([f] + out)
        prior = line
    return raw


ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]  # (x0, y0, dx, dy) of the seven passes


def _png(px, ctype, filters, palette=None, interlace=0):
    """A PNG of ``px`` [H, W, samples] uint8 (Adam7-interlaced if asked)."""
    h, w, _ = px.shape
    if interlace:
        raw = b"".join(_filtered(px[y0::dy, x0::dx], filters) for x0, y0, dx, dy in ADAM7)
    else:
        raw = _filtered(px, filters)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                               0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


KINDS = {"gray": (0, 1), "RGB": (2, 3), "palette": (3, 1), "gray+alpha": (4, 2), "RGBA": (6, 4)}


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_decoder_matches_pillow(kind, filt):
    ctype, bpp = KINDS[kind]
    rs = np.random.RandomState(ctype * 10 + filt)
    px = rs.randint(0, 256, (6, 11, bpp)).astype(np.uint8)
    palette = rs.randint(0, 256, (256, 3)).astype(np.uint8) if ctype == 3 else None
    data = _png(px, ctype, [filt, (filt + 1) % 5], palette)  # two filters, alternating
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = timages.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (6, 11, 3)
    np.testing.assert_array_equal(got, ref)


def test_png_decoder_reads_pillows_own_pngs():
    rs = np.random.RandomState(3)
    for mode, shape in (("RGB", (9, 13, 3)), ("RGBA", (9, 13, 4)), ("L", (9, 13)),
                        ("LA", (9, 13, 2))):
        im = Image.fromarray(rs.randint(0, 256, shape).astype(np.uint8), mode)
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        np.testing.assert_array_equal(timages.decode_png(buf.getvalue()),
                                      np.asarray(im.convert("RGB")), err_msg=mode)


@pytest.mark.parametrize("case", ["16-bit", "interlaced", "jpeg"])
def test_other_formats_go_through_pillow_or_raise_naming_the_format(tmp_path, monkeypatch, case):
    rs = np.random.RandomState(4)
    if case == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(buf, format="JPEG")
        data, words = buf.getvalue(), "not a PNG"
    elif case == "16-bit":
        buf = io.BytesIO()
        Image.fromarray(rs.randint(0, 65535, (8, 8)).astype(np.uint16)).save(buf, format="PNG")
        data, words = buf.getvalue(), "16-bit gray"
    else:
        data = _png(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8), 2, [0, 1], interlace=1)
        words = "8-bit RGB, interlaced"
    path = tmp_path / "img"
    path.write_bytes(data)
    with pytest.raises(timages.UnsupportedImage, match=words):
        timages.decode_png(data)
    np.testing.assert_array_equal(timages.decode_image(str(path)),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(timages.UnsupportedImage, match=words):
        timages.decode_image(str(path))


def test_a_broken_png_raises():
    data = bytearray(_png(np.zeros((2, 2, 3), np.uint8), 2, [0]))
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer fits
    with pytest.raises(ValueError, match="bad CRC"):
        timages.decode_png(bytes(data))


# ---------------------------------------------------------------------------
# Pillow's resize and load_image_rgb
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,size", [((37, 53), (64, 64)), ((300, 200), (64, 64)),
                                      ((100, 150), (17, 211)), ((513, 257), (256, 256)),
                                      ((20, 30), (30, 20)), ((64, 64), (64, 64))])
def test_resize_like_pillow_within_one_lsb(src, size):
    rs = np.random.RandomState(5)
    for img in (rs.randint(0, 256, src + (3,)).astype(np.uint8),
                (np.add.outer(np.arange(src[0]), 2 * np.arange(src[1]))[..., None]
                 * [1, 3, 7] % 256).astype(np.uint8)):
        ref = np.asarray(Image.fromarray(img).resize(size)).astype(int)
        got = timages.resize_like_pillow(img, size).astype(int)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1


@pytest.mark.parametrize("kind", ["RGB", "palette", "gray+alpha"])
@pytest.mark.parametrize("size", [64, (48, 80)])
def test_load_image_rgb_matches_cgd_tpu_without_pillow(tmp_path, monkeypatch, kind, size):
    ctype, bpp = KINDS[kind]
    rs = np.random.RandomState(6)
    px = rs.randint(0, 256, (45, 70, bpp)).astype(np.uint8)
    palette = rs.randint(0, 256, (256, 3)).astype(np.uint8) if ctype == 3 else None
    path = tmp_path / "init.png"
    path.write_bytes(_png(px, ctype, [0, 1, 2, 3, 4], palette))
    ref = jimages.load_image_rgb(str(path), size)
    monkeypatch.setitem(sys.modules, "PIL", None)  # the port reads it without Pillow
    got = timages.load_image_rgb(str(path), size)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2 / 255 + 1e-6


# ---------------------------------------------------------------------------
# q_sample and the image-prompt path
# ---------------------------------------------------------------------------

def test_q_sample_matches_cgd_tpu():
    rs = np.random.RandomState(7)
    x0, noise = rs.randn(3, 8, 8, 3).astype(np.float32), rs.randn(3, 8, 8, 3).astype(np.float32)
    t = np.array([0, 12, 24])
    jd, td = (m.make_diffusion(timestep_respacing="ddim25") for m in (jgauss, tgauss))
    np.testing.assert_allclose(
        td.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)).numpy(),
        np.asarray(jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))),
        rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_clip():
    jcfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["ViT-B/32"], vision=jconfigs.VisionViTConfig(16, 8, 32, 1, 2),
        text=jconfigs.TextConfig(context_length=8, vocab_size=50, width=32, heads=2, layers=1),
        embed_dim=16)
    tcfg = tconfigs.CLIPConfig(jcfg.name, 16, tconfigs.VisionViTConfig(16, 8, 32, 1, 2),
                               tconfigs.TextConfig(8, 50, 32, 2, 1))
    params = jclip.init_clip(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, params, load_from_jax(tclip.CLIP(tcfg), params)


@pytest.mark.parametrize("strict_parity", [True, False], ids=["strict", "clip_normalized"])
def test_image_prompt_embeddings_match_cgd_tpu(tmp_path, tiny_clip, strict_parity):
    jcfg, tcfg, params, model = tiny_clip
    rs = np.random.RandomState(8)
    path = tmp_path / "prompt.png"
    path.write_bytes(timages.encode_png(rs.randint(0, 256, (50, 90, 3)).astype(np.uint8)))
    image_size = 40
    # cgd_tpu's steps (api.py:_encode_image_prompt) up to the cutouts
    pil = Image.open(str(path)).convert("RGB")
    ref_img = np.asarray(jresample.resize(jnp.asarray(np.asarray(pil, np.float32) / 255.0),
                                          (min(image_size, *pil.size),)))
    img = tapi._prompt_image(str(path), image_size, "cpu")
    assert tuple(img.shape) == ref_img.shape == (40, 90, 3)  # H resized only
    np.testing.assert_allclose(img.numpy(), ref_img, rtol=1e-6, atol=2e-6)

    size = np.array([40.0, 24.0, 17.0], np.float32)
    ox = np.floor(rs.rand(3) * (90 - size + 1)).astype(np.float32)
    oy = np.floor(rs.rand(3) * (40 - size + 1)).astype(np.float32)
    ref = np.asarray(japi._image_prompt_encoder(jcfg, strict_parity)(
        params, jnp.asarray(ref_img), JSpec(jnp.asarray(ox), jnp.asarray(oy), jnp.asarray(size))))
    got = tapi.encode_image_prompt(model, tcfg, img, TSpec(*map(torch.from_numpy, (ox, oy, size))),
                                   strict_parity).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
