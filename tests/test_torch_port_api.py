"""cgd_tpu_torch.api.clip_guided_diffusion on the CPU at toy size
(CGD_TPU_DEBUG_TINY=1, random weights, 64px): the JAX package's output tree,
valid PNG files, the device rule (no silent CPU run when CUDA is asked for),
options outside the ported slice raising, and the copied prompt parser,
tokenizer, registry and parameter validation pinned to the originals."""

import inspect
import struct
import threading
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgd_tpu import api as japi  # noqa: E402
from cgd_tpu import registry as jregistry  # noqa: E402
from cgd_tpu import validate as jvalidate  # noqa: E402
from cgd_tpu.api import _FallbackTokenizer as JTokenizer  # noqa: E402
from cgd_tpu.guidance.prompts import parse_prompt as jparse  # noqa: E402
from cgd_tpu.io_utils import images as jimages  # noqa: E402
from cgd_tpu_torch import api  # noqa: E402
from cgd_tpu_torch import registry as tregistry  # noqa: E402
from cgd_tpu_torch import validate as tvalidate  # noqa: E402
from cgd_tpu_torch.guidance.prompts import parse_prompt as tparse  # noqa: E402
from cgd_tpu_torch.io_utils import images as timages  # noqa: E402

torch.set_num_threads(2)

KW = dict(prompts=["a red cube:2", "blue sky"], image_size=64, num_cutouts=2,
          timestep_respacing="ddim5", weights_mode="random", device="cpu",
          compute_dtype="float32", progress=False)


def _read_png(path):
    """Minimal PNG decoder for the encoder's output (8-bit RGB, filter 0)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = hdr[0], hdr[1]
    assert hdr[2:] == (8, 2, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_output_tree_and_pngs(tiny):
    frames = list(api.clip_guided_diffusion(prefix_path=tiny / "outputs", save_frequency=2,
                                            batch_size=2, **KW))
    slug_dir = jimages.clean_and_combine_prompts(tiny / "outputs", KW["prompts"], 0)
    expect = []
    for step in (0, 2, 4):
        for b in (0, 1):
            expect.append((b, jimages.clean_and_combine_prompts(tiny / "outputs", KW["prompts"], b)
                           + f"/{step:04}.png"))
    assert frames == expect
    assert slug_dir.endswith("a_red_cube2_blue_sky/00")
    for _, path in frames:
        img = _read_png(path)
        assert img.shape == (64, 64, 3)
    assert _read_png(tiny / "current.png").shape == (64, 64, 3)


def test_same_seed_same_frames_and_cached_cutouts(tiny):
    a = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "a", seed=3, randomize_class=True, **KW)]
    b = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "b", seed=3, randomize_class=True, **KW)]
    assert a == b
    c = list(api.clip_guided_diffusion(prefix_path=tiny / "c", cached_cutouts=True,
                                       timestep_respacing="3", **{k: v for k, v in KW.items()
                                                                  if k != "timestep_respacing"}))
    assert len(c) == 2  # steps 0 and the final step 2 (save_frequency 25)


def test_png_encoder_round_trips(tmp_path):
    rgb = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(timages.encode_png(rgb))
    np.testing.assert_array_equal(_read_png(path), rgb)
    img = np.linspace(-1.2, 1.2, 5 * 7 * 3, dtype=np.float32).reshape(5, 7, 3)
    np.testing.assert_array_equal(timages.to_uint8(img),
                                  np.asarray(jimages.to_pil_image(img)))


def test_cuda_device_without_a_card_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        next(api.clip_guided_diffusion(**{**KW, "device": "cuda"}))
    with pytest.raises(RuntimeError, match="cuda"):
        next(api.clip_guided_diffusion(prompts=["x"], weights_mode="random"))


@pytest.mark.parametrize("option", [
    {"image_prompts": ["x.png"]}, {"init_image": "x.png"}, {"use_augs": True},
    {"dpm_solver": True}, {"fast_guidance": True}, {"checkpoint_path": "ck.npz"},
    {"skip_timesteps": 3}, {"weights_mode": "auto"},
])
def test_options_outside_the_slice_raise(tiny, option):
    with pytest.raises(NotImplementedError):
        next(api.clip_guided_diffusion(**{**KW, **option}))


def _default(p):
    """A parameter's default, an empty sequence as ``()`` (the port takes
    ``()`` where the JAX package writes ``[]``)."""
    return tuple(p.default) if isinstance(p.default, (list, tuple)) else p.default


def test_signature_matches_the_jax_api():
    """Every keyword of cgd_tpu.api.clip_guided_diffusion, in its order and
    with its default; only ``device`` differs (the port's runs on the card
    unless asked for the CPU)."""
    jp = inspect.signature(japi.clip_guided_diffusion).parameters
    tp = inspect.signature(api.clip_guided_diffusion).parameters
    assert list(tp) == list(jp)
    assert jp["device"].default == "" and tp["device"].default == "cuda"
    for name in jp:
        assert tp[name].kind == jp[name].kind, name
        if name != "device":
            assert _default(tp[name]) == _default(jp[name]), name


@pytest.mark.parametrize("option", [
    {"checkpoints_dir": "ckpts"}, {"wandb_entity": "team"}, {"noise_file": "noise.npz"},
    {"async_frames": True}, {"log_losses": True}, {"strict_parity": False},
    {"stall_pet": lambda phase: None}, {"device_lock": threading.Lock()},
], ids=lambda o: next(iter(o)))
def test_jax_keywords_the_port_cannot_honour_raise_by_name(tiny, option):
    (name,) = option
    with pytest.raises(NotImplementedError, match=name):
        next(api.clip_guided_diffusion(**{**KW, **option}))


def test_dropout_is_taken_and_never_applied(tiny):
    """Sampling runs the UNet without dropout, as the JAX package's does."""
    a = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "a", dropout=0.0, **KW)]
    b = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "b", dropout=0.3, **KW)]
    assert a == b


def test_invalid_parameters_raise_via_check_parameters(tiny):
    with pytest.raises(ValueError, match="at least one prompt"):
        next(api.clip_guided_diffusion(**{**KW, "prompts": []}))


@pytest.mark.parametrize("prompt", [
    "a cat", "a cat:0.5", "a:b:2", "http://x/a.png", "https://x/a.png:0.25", "weird:",
])
def test_parse_prompt_copy_matches_original(prompt):
    try:
        ref = jparse(prompt)
    except ValueError:
        with pytest.raises(ValueError):
            tparse(prompt)
        return
    assert tparse(prompt) == ref


def test_fallback_tokenizer_copy_matches_original():
    texts = ["A red cube", "blue sky at night " * 30, ""]
    np.testing.assert_array_equal(api._FallbackTokenizer(49408).tokenize(texts),
                                  JTokenizer(49408).tokenize(texts))


def test_registry_copy_matches_original():
    for name in ("DIFFUSION_LOOKUP", "CLIP_MODEL_URLS", "CLIP_MODEL_NAMES", "TIMESTEP_RESPACINGS",
                 "DIFFUSION_SCHEDULES", "IMAGE_SIZES"):
        assert getattr(tregistry, name) == getattr(jregistry, name), name


@pytest.mark.parametrize("over", [
    {}, {"prompts": []}, {"prompts": [], "image_prompts": ["x.png"]},
    {"noise_schedule": "cos"}, {"image_size": 100}, {"timestep_respacing": "ddimx"},
    {"timestep_respacing": "10,15"}, {"save_frequency": 0}, {"save_frequency": 30},
    {"save_frequency": 10**9}, {"diffusion_steps": 300}, {"clip_model_name": "RN999"},
    {"clip_model_name": "missing.pt"}, {"clip_model_name": "ViT-L/14@336px"},
])
def test_check_parameters_copy_matches_original(capsys, over):
    kw = dict(prompts=["a"], image_prompts=[], image_size=256, timestep_respacing="ddim25",
              diffusion_steps=1000, clip_model_name="ViT-B/32", save_frequency=5,
              noise_schedule="linear")
    kw.update(over)
    outcomes = []
    for fn in (jvalidate.check_parameters, tvalidate.check_parameters):
        try:
            fn(**kw)
            err = None
        except (ValueError, AssertionError) as e:
            err = (type(e), str(e))
        outcomes.append((err, capsys.readouterr().out))
    assert outcomes[0] == outcomes[1]
