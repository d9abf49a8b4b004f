"""cgd_tpu_torch.api.clip_guided_diffusion on the CPU at toy size
(CGD_TPU_DEBUG_TINY=1, random weights, 64px): the JAX package's output tree,
valid PNG files, the device rule (no silent CPU run when CUDA is asked for),
options outside the ported slice raising, the init-image path (init image,
skip, LPIPS init loss, image prompts, both parity modes), checkpoint loading
from a temporary ``checkpoints_dir`` (tests/torch_port_toy_checkpoints.py),
and the copied prompt parser, tokenizer, registry and parameter validation
pinned to the originals."""

import inspect
import os
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
from cgd_tpu_torch.models import vgg_lpips as tlpips  # noqa: E402
from tests import torch_port_toy_checkpoints as toy  # noqa: E402

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
    {"reduce_clip": True}, {"progressive_cutout": True}, {"use_augs": True},
    {"dpm_solver": True}, {"fast_guidance": True}, {"checkpoint_path": "ck.npz"},
    {"height_offset": 8}, {"resume_from": "ck.npz"},
])
def test_options_outside_the_slice_raise(tiny, option):
    with pytest.raises(NotImplementedError):
        next(api.clip_guided_diffusion(**{**KW, **option}))


def _png_file(path, h, w, seed):
    rgb = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    path.write_bytes(timages.encode_png(rgb))
    return str(path)


@pytest.mark.parametrize("option", ["image_prompts", "init_image", "skip_timesteps",
                                    "weights_mode"])
def test_the_init_image_path_options_work(tiny, monkeypatch, option):
    """Each option that used to raise now reaches the run: an image prompt's
    embeddings join the targets, the init image is noised in as the start,
    the skip shortens the run, and weights_mode="auto" loads the
    reference-layout checkpoints of a temporary checkpoints_dir."""
    base = api.clip_guided_diffusion(prefix_path=tiny / "base", save_frequency=1, **KW)
    base = [open(p, "rb").read() for _, p in base]
    kw = dict(KW, save_frequency=1, prefix_path=tiny / "out")
    if option == "image_prompts":
        kw["image_prompts"] = [_png_file(tiny / "p.png", 50, 90, 1) + ":0.5"]
    elif option == "init_image":
        kw["init_image"] = _png_file(tiny / "init.png", 80, 70, 2)
    elif option == "skip_timesteps":
        kw["skip_timesteps"] = 3
    else:
        toy.install(monkeypatch, tiny, tiny / "ckpts")
        kw.update(weights_mode="auto", checkpoints_dir=str(tiny / "ckpts"))
    frames = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(**kw)]
    assert len(frames) == (2 if option == "skip_timesteps" else 5)
    if option != "skip_timesteps":
        assert frames != base
    if option == "weights_mode":
        assert (tiny / "ckpts" / "toy_unet.pt.npz.cgd").is_file()
        assert (tiny / "ckpts" / "clip" / "ViT-B-32.pt.npz.cgd").is_file()


def test_init_skip_init_scale_and_an_image_prompt_run_together(tiny, monkeypatch):
    """The tentpole's path at toy size: the LPIPS distance is taken at every
    guided step (against the init image), and nothing else changes the
    frame count: ddim5 with skip 2 saves steps 0, 1, 2."""
    calls = []
    real = tlpips.lpips_distance

    def counted(model, x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return real(model, x, y)

    monkeypatch.setattr("cgd_tpu_torch.guidance.pipeline.lpips_distance", counted)
    frames = list(api.clip_guided_diffusion(
        init_image=_png_file(tiny / "init.png", 64, 64, 3), skip_timesteps=2, init_scale=1000,
        image_prompts=[_png_file(tiny / "p.png", 40, 60, 4)], prefix_path=tiny / "out",
        save_frequency=1, batch_size=2, **KW))
    assert [b for b, _ in frames] == [0, 1] * 3
    assert calls == [((2, 64, 64, 3), (2, 64, 64, 3))] * 3
    for _, path in frames:
        assert _read_png(path).shape == (64, 64, 3)


@pytest.mark.parametrize("strict_parity", [True, False])
def test_the_final_frame_with_a_skip_follows_strict_parity(tiny, strict_parity):
    """ddim6 with skip 2 runs steps 0-3; save_frequency 2 saves 0 and 2, and
    the last step only without strict parity (the reference never saves it
    when skip > 0, cgd/cgd.py:268)."""
    frames = list(api.clip_guided_diffusion(
        **{**KW, "timestep_respacing": "ddim6"}, skip_timesteps=2, save_frequency=2,
        prefix_path=tiny / "out", strict_parity=strict_parity))
    steps = [os.path.basename(p) for _, p in frames]
    assert steps == (["0000.png", "0002.png"] if strict_parity
                     else ["0000.png", "0002.png", "0003.png"])


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
    {"wandb_project": "proj"}, {"wandb_entity": "team"}, {"noise_file": "noise.npz"},
    {"async_frames": True}, {"log_losses": True}, {"width_offset": 8},
    {"stall_pet": lambda phase: None}, {"device_lock": threading.Lock()},
], ids=lambda o: next(iter(o)))
def test_jax_keywords_the_port_cannot_honour_raise_by_name(tiny, option):
    (name,) = option
    with pytest.raises(NotImplementedError, match=name):
        next(api.clip_guided_diffusion(**{**KW, **option}))


@pytest.mark.parametrize("name", ["checkpoints_dir", "strict_parity"])
def test_jax_keywords_the_port_now_honours(tiny, monkeypatch, name):
    """``checkpoints_dir``: created, its reference-layout .pt files converted
    into .npz.cgd caches beside them, which a second run reads with the .pt
    files gone. ``strict_parity=False``: image prompts CLIP-normalized, so
    their embeddings, and the frames, differ from the strict run's."""
    if name == "checkpoints_dir":
        ckpts = tiny / "nested" / "ckpts"
        toy.install(monkeypatch, tiny, ckpts)
        kw = dict(KW, weights_mode="auto", checkpoints_dir=str(ckpts))
        first = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
            prefix_path=tiny / "a", **kw)]
        os.remove(ckpts / "toy_unet.pt")
        os.remove(ckpts / "clip" / "ViT-B-32.pt")
        again = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
            prefix_path=tiny / "b", **kw)]
        assert first == again and len(first) == 2
        return
    prompt = _png_file(tiny / "p.png", 48, 48, 5)
    runs = [[open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        **KW, image_prompts=[prompt], prefix_path=tiny / str(sp), strict_parity=sp)]
        for sp in (True, False)]
    assert runs[0] != runs[1]


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
