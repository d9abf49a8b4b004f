"""cgd_tpu_torch.api.clip_guided_diffusion on the CPU at toy size
(CGD_TPU_DEBUG_TINY=1, random weights, 64px): the JAX package's output tree,
valid PNG files, the device rule (no silent CPU run when CUDA is asked for),
the keywords once refused now honoured, the init-image path (init image,
skip, LPIPS init loss, image prompts, both parity modes), checkpoint loading
from a temporary ``checkpoints_dir`` (tests/torch_port_toy_checkpoints.py),
and the copied prompt parser, tokenizer, registry and parameter validation
pinned to the originals."""

import inspect
import json
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
from cgd_tpu_torch import weights as tweights  # noqa: E402
from cgd_tpu_torch.guidance.prompts import parse_prompt as tparse  # noqa: E402
from cgd_tpu_torch.io_utils import images as timages  # noqa: E402
from cgd_tpu_torch.models import vgg_lpips as tlpips  # noqa: E402
from tests import torch_port_toy_checkpoints as toy  # noqa: E402
from tests.torch_port_toy_checkpoints import no_kept_models  # noqa: E402,F401

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


def test_an_f32_call_runs_with_tf32_off_and_restores_the_flags(tiny, monkeypatch):
    """compute_dtype="float32": cuDNN's and cuBLAS's TF32 are off while the
    generator runs (read inside each sampling step), and the caller's flags
    are back at every yield, after the run, and after a run closed early."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    inside = []
    real_loop = api.sample_loop

    def spy(*a, **kw):
        for item in real_loop(*a, **kw):
            inside.append((cudnn.allow_tf32, matmul.allow_tf32))
            yield item

    monkeypatch.setattr(api, "sample_loop", spy)
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        between = []
        for _ in api.clip_guided_diffusion(prefix_path=tiny / "a", save_frequency=2, **KW):
            between.append((cudnn.allow_tf32, matmul.allow_tf32))
        after = cudnn.allow_tf32, matmul.allow_tf32
        gen = api.clip_guided_diffusion(prefix_path=tiny / "b", **KW)
        next(gen)
        gen.close()
        closed = cudnn.allow_tf32, matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
    assert len(inside) == 4 and set(inside) == {(False, False)}
    assert len(between) == 3 and set(between) == {(True, True)}
    assert after == closed == (True, True)


def test_a_mesh_at_float32_on_cuda_gets_past_the_argument_checks(tiny):
    """K-halo has an f32 kernel: mesh= with compute_dtype float32 on CUDA is
    no longer refused; without a card it stops where every CUDA call does,
    at resolve_device's RuntimeError."""
    from cgd_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([torch.device("cuda", 0)] * 2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        next(api.clip_guided_diffusion(**{**KW, "device": "cuda", "mesh": mesh}))


@pytest.mark.parametrize("option", [{"checkpoint_path": "ck.npz"}, {"resume_from": "ck.npz"}])
def test_options_outside_the_slice_raise(tiny, option):
    """Resume, once outside the slice and refused, runs: checkpoint_path
    writes the sampling state after every segment, and resume_from raises
    by name only for a file that is not a readable checkpoint (here: none
    exists). The rest: tests/test_torch_port_resume.py."""
    (name,) = option
    if name == "checkpoint_path":
        frames = list(api.clip_guided_diffusion(**{**KW, **option}, prefix_path=tiny / "o"))
        assert len(frames) == 2 and int(np.load(tiny / "ck.npz")["next_seg"]) == 2
        return
    with pytest.raises(ValueError, match="resume_from 'ck.npz' is not a readable checkpoint"):
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
    {"wandb_project": "proj"}, {"wandb_entity": "team"}, {"async_frames": True},
    {"log_losses": True}, {"stall_pet": lambda phase: None},
    {"device_lock": threading.Lock()},
], ids=lambda o: next(iter(o)))
def test_jax_keywords_the_port_cannot_honour_raise_by_name(tiny, monkeypatch, capsys, option):
    """Every keyword once refused by name is honoured now: W&B goes on
    without ``wandb`` (as the JAX package does), asynchronous frames are on
    disk when the run ends, loss lines are printed, the stall pets arrive,
    the device lock is taken and released. (Each in depth:
    tests/test_torch_port_cli_options.py, test_torch_port_serve.py,
    test_torch_port_tf32.py.)"""
    (name,) = option
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)
    pets = []
    if name == "stall_pet":
        option = {"stall_pet": pets.append}
    paths = [p for _, p in api.clip_guided_diffusion(**{**KW, **option}, save_frequency=2,
                                                     prefix_path=tiny / "o")]
    assert len(paths) == 3 and all(os.path.isfile(p) for p in paths)
    out = capsys.readouterr().out
    if name == "wandb_project":
        assert "continuing without logging" not in out  # progress=False says nothing
    if name == "log_losses":
        assert len([ln for ln in out.splitlines() if ln.startswith("CLIP Loss: ")]) == 5
    if name == "stall_pet":
        assert pets[0] == "resolve model checkpoints" and pets[-1] == "sampling (5 steps done)"
    if name == "device_lock":
        assert not option["device_lock"].locked()


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
        tweights.clear_model_cache()  # read from the caches, not kept from the first run
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


def _loop_raising_after_one_frame(real_loop, exc):
    """A sample_loop that yields the real loop's first frame, then raises."""
    def loop(*a, **kw):
        inner = real_loop(*a, **kw)
        yield next(inner)
        raise exc
    return loop


def test_an_interrupt_keeps_the_first_frame_and_ends_like_cgd_tpu(tiny, monkeypatch, capsys):
    """Ctrl-C during sampling: the port's generator yields the frame it has,
    says so and ends without raising, as the JAX package's does under the
    same patch; the caller's TF32 flags are back after an f32 run."""
    monkeypatch.setattr(api, "sample_loop",
                        _loop_raising_after_one_frame(api.sample_loop, KeyboardInterrupt()))
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        try:
            frames = list(api.clip_guided_diffusion(prefix_path=tiny / "t",
                                                    **{**KW, "progress": True}))
        except KeyboardInterrupt:
            pytest.fail("the interrupt escaped the port's generator")
        flags = cudnn.allow_tf32, matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
    said = capsys.readouterr().out
    monkeypatch.setattr(japi, "sample_loop",
                        _loop_raising_after_one_frame(japi.sample_loop, KeyboardInterrupt()))
    jframes = list(japi.clip_guided_diffusion(
        prompts=KW["prompts"], image_size=64, num_cutouts=2, timestep_respacing="ddim5",
        weights_mode="random", prefix_path=tiny / "j", progress=True))
    jsaid = capsys.readouterr().out
    assert [b for b, _ in frames] == [b for b, _ in jframes] == [0]
    assert frames[0][1].endswith("/00/0000.png") and jframes[0][1].endswith("/00/0000.png")
    assert _read_png(frames[0][1]).shape == (64, 64, 3)
    assert "Interrupted — partial frames kept." in said
    assert "Interrupted — partial frames kept." in jsaid
    assert flags == (True, True)


@pytest.mark.parametrize("exc", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("cuDNN error: CUDNN_STATUS_INTERNAL_ERROR: out of memory"),
    RuntimeError("an unrelated failure"),
], ids=["OutOfMemoryError", "out-of-memory-text", "other"])
def test_out_of_memory_prints_the_advice_and_raises(tiny, monkeypatch, capsys, exc):
    """An out-of-memory error during sampling prints OOM_ADVICE and the CLIP
    model's name, then raises it again (cgd_tpu/api.py:892-899); another
    error raises with no advice. The caller's TF32 flags are restored."""
    monkeypatch.setattr(api, "sample_loop", _loop_raising_after_one_frame(api.sample_loop, exc))
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    frames = []
    try:
        with pytest.raises(type(exc)) as raised:
            for item in api.clip_guided_diffusion(prefix_path=tiny / "o", **KW):
                frames.append(item)
        flags = cudnn.allow_tf32, matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
    assert raised.value is exc and len(frames) == 1 and flags == (True, True)
    said = capsys.readouterr().out
    oom = "out of memory" in str(exc).lower()
    assert (tvalidate.OOM_ADVICE in said) == oom
    assert ("(CLIP model currently: ViT-B/32)" in said) == oom


def test_the_oom_advice_names_the_jax_packages_flags_for_the_card():
    """The port's advice names the flags cgd_tpu's does and speaks of the
    card's memory, not the TPU's HBM."""
    import re

    flags = set(re.findall(r"--?[a-z_]+", jvalidate.OOM_ADVICE))
    assert flags and flags == set(re.findall(r"--?[a-z_]+", tvalidate.OOM_ADVICE))
    assert "GPU" in tvalidate.OOM_ADVICE and "HBM" not in tvalidate.OOM_ADVICE
    assert "TPU" not in tvalidate.OOM_ADVICE



# ---- the run meta ---------------------------------------------------------
# Each case: the call's arguments beside KW's device / weights, what the call
# settles (skip_timesteps after reduce_clip, use_magnitude at 64px, the
# generator's device type, the remat gate) and the meta's JSON as the API
# wrote it before its body was cut into stages: a checkpoint written then
# resumes now only if these bytes stay.
META_CASES = {
    "defaults": (
        dict(prompts=["a lighthouse"]),
        dict(skip_timesteps=0, use_magnitude=False, generator="cpu", unet_remat=False),
        '{"cached_cutouts": false, "class_cond": true, "clip_guidance_scale": 1000.0, '
        '"clip_model_name": "ViT-B/32", "compute_dtype": "bfloat16", "cutout_power": 1.0, '
        '"diffusion_steps": 1000, "dpm_solver": false, "fast_guidance": false, '
        '"generator": "cpu", "image_prompts": [], "init_scale": 0.0, '
        '"noise_schedule": "linear", "num_cutouts": 16, "package": "cgd_tpu_torch", '
        '"progressive_cutout": false, "prompts": ["a lighthouse"], "randomize_class": true, '
        '"range_scale": 50.0, "reduce_clip": false, "sat_scale": 0.0, "save_frequency": 25, '
        '"seed": 0, "shape": [1, 128, 128, 3], "skip_timesteps": 0, "strict_parity": true, '
        '"timestep_respacing": "1000", "tv_scale": 150.0, "unet_remat": false, '
        '"use_augs": false, "use_magnitude": false}'),
    "remat512_batch16": (
        dict(prompts=["a lighthouse"], image_size=512, batch_size=16),
        dict(skip_timesteps=0, use_magnitude=False, generator="cpu", unet_remat=True),
        '{"cached_cutouts": false, "class_cond": true, "clip_guidance_scale": 1000.0, '
        '"clip_model_name": "ViT-B/32", "compute_dtype": "bfloat16", "cutout_power": 1.0, '
        '"diffusion_steps": 1000, "dpm_solver": false, "fast_guidance": false, '
        '"generator": "cpu", "image_prompts": [], "init_scale": 0.0, '
        '"noise_schedule": "linear", "num_cutouts": 16, "package": "cgd_tpu_torch", '
        '"progressive_cutout": false, "prompts": ["a lighthouse"], "randomize_class": true, '
        '"range_scale": 50.0, "reduce_clip": false, "sat_scale": 0.0, "save_frequency": 25, '
        '"seed": 0, "shape": [16, 512, 512, 3], "skip_timesteps": 0, "strict_parity": true, '
        '"timestep_respacing": "1000", "tv_scale": 150.0, "unet_remat": true, '
        '"use_augs": false, "use_magnitude": false}'),
    "f32_dpm_progressive_cached": (
        dict(prompts=["a red cube:2", "blue sky"], image_size=64, num_cutouts=12,
             compute_dtype="float32", dpm_solver=True, progressive_cutout=True,
             cached_cutouts=True, reduce_clip=True, timestep_respacing="ddim10",
             clip_guidance_scale=500, tv_scale=80.5, seed=5),
        dict(skip_timesteps=2, use_magnitude=True, generator="cpu", unet_remat=False),
        '{"cached_cutouts": true, "class_cond": true, "clip_guidance_scale": 500.0, '
        '"clip_model_name": "ViT-B/32", "compute_dtype": "float32", "cutout_power": 1.0, '
        '"diffusion_steps": 1000, "dpm_solver": true, "fast_guidance": false, '
        '"generator": "cpu", "image_prompts": [], "init_scale": 0.0, '
        '"noise_schedule": "linear", "num_cutouts": 12, "package": "cgd_tpu_torch", '
        '"progressive_cutout": true, "prompts": ["a red cube:2", "blue sky"], '
        '"randomize_class": true, "range_scale": 50.0, "reduce_clip": true, '
        '"sat_scale": 0.0, "save_frequency": 25, "seed": 5, "shape": [1, 64, 64, 3], '
        '"skip_timesteps": 2, "strict_parity": true, "timestep_respacing": "ddim10", '
        '"tv_scale": 80.5, "unet_remat": false, "use_augs": false, "use_magnitude": true}'),
    "offsets_image_prompts": (
        dict(prompts=["x"], image_prompts=["prompt.png:2"], height_offset=16, width_offset=-32,
             strict_parity=False, batch_size=2, seed=7, use_augs=True, num_cutouts=2,
             sat_scale=3, class_cond=False, randomize_class=False, image_size=256,
             timestep_respacing="25", diffusion_steps=500, noise_schedule="cosine",
             save_frequency=5, skip_timesteps=3, fast_guidance=True, cutout_power=0.5),
        dict(skip_timesteps=3, use_magnitude=False, generator="cpu", unet_remat=False),
        '{"cached_cutouts": false, "class_cond": false, "clip_guidance_scale": 1000.0, '
        '"clip_model_name": "ViT-B/32", "compute_dtype": "bfloat16", "cutout_power": 0.5, '
        '"diffusion_steps": 500, "dpm_solver": false, "fast_guidance": true, '
        '"generator": "cpu", "image_prompts": ["prompt.png:2"], "init_scale": 0.0, '
        '"noise_schedule": "cosine", "num_cutouts": 2, "package": "cgd_tpu_torch", '
        '"progressive_cutout": false, "prompts": ["x"], "randomize_class": false, '
        '"range_scale": 50.0, "reduce_clip": false, "sat_scale": 3.0, "save_frequency": 5, '
        '"seed": 7, "shape": [2, 272, 224, 3], "skip_timesteps": 3, "strict_parity": false, '
        '"timestep_respacing": "25", "tv_scale": 150.0, "unet_remat": false, '
        '"use_augs": true, "use_magnitude": false}'),
}


@pytest.mark.parametrize("path", ["direct", "through the API"])
@pytest.mark.parametrize("case", list(META_CASES))
def test_the_run_meta_keeps_its_bytes(tiny, monkeypatch, case, path):
    """``_run_meta`` alone, and as a checkpoint of the call holds it (the
    loop stubbed to hand over one state), gives the recorded JSON."""
    monkeypatch.delenv("CGD_TPU_REMAT", raising=False)
    given, settled, want = META_CASES[case]
    args = {**{k: p.default for k, p in inspect.signature(api.clip_guided_diffusion)
               .parameters.items()}, "weights_mode": "random", "device": "cpu", **given}
    if path == "direct":
        assert json.dumps(api._run_meta(args, **settled), sort_keys=True) == want
        return
    (tiny / "prompt.png").write_bytes(timages.encode_png(np.full((40, 48, 3), 128, np.uint8)))

    def one_state(*a, state_sink, **kw):
        state_sink(1, {"x": np.zeros(1), "y": None, "x0p": None,
                       "generator": np.zeros(1, np.uint8)})
        return iter(())

    monkeypatch.setattr(api, "sample_loop", one_state)
    assert list(api.clip_guided_diffusion(**{**args, "progress": False,
                                             "prefix_path": tiny / "o",
                                             "checkpoint_path": str(tiny / "ck.npz")})) == []
    assert str(np.load(tiny / "ck.npz")["meta"]) == want


# ---- the device hold ------------------------------------------------------

def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def caller_flags():
    """The caller's TF32 flags both on for the test, the machine's after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = _flags()
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    yield
    cudnn.allow_tf32, matmul.allow_tf32 = prev


class _Lock:
    """A device lock that records into ``events`` each acquisition and each
    release with the TF32 flags at that moment; its first ``busy`` tries
    fail, as while another run holds it."""

    def __init__(self, events, busy=0):
        self.events, self.busy, self.held = events, busy, False

    def acquire(self, timeout=-1):
        assert timeout == 5.0 and not self.held
        if self.busy:
            self.busy -= 1
            return False
        self.held = True
        self.events.append("acquire")
        return True

    def release(self):
        assert self.held
        self.held = False
        self.events.append(("release", _flags()))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_the_device_hold_takes_the_lock_at_its_stage_and_lends_the_flags_at_each_yield(
        tiny, monkeypatch, caller_flags, compute_dtype):
    """A bfloat16 run takes the lock only at sampling, an f32 run before
    its prompts; an f32 run samples with TF32 off; the caller's flags are
    back at every yield, and when the lock is released at the end."""
    events = []
    lock, real_loop = _Lock(events), api.sample_loop

    def spy(*a, **kw):
        for item in real_loop(*a, **kw):
            events.append(("sampling", _flags()))
            yield item

    monkeypatch.setattr(api, "sample_loop", spy)
    for _ in api.clip_guided_diffusion(**{**KW, "compute_dtype": compute_dtype},
                                       prefix_path=tiny / "o", save_frequency=2,
                                       device_lock=lock, stall_pet=events.append):
        events.append(("yield", _flags()))
    taken, prompts = events.index("acquire"), events.index("encode prompts")
    if compute_dtype == "float32":
        assert taken < prompts
    else:
        assert prompts < taken < events.index("compile + first sampling segment")
    marks = [e for e in events if isinstance(e, tuple)]
    inside = {(False, False)} if compute_dtype == "float32" else {(True, True)}
    assert {f for what, f in marks if what == "sampling"} == inside
    assert [f for what, f in marks if what == "yield"] == [(True, True)] * 3
    assert events.count("acquire") == 1 and events[-1] == ("release", (True, True))
    assert not lock.held and _flags() == (True, True)


@pytest.mark.parametrize("end", ["exception", "close"])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_the_device_hold_is_given_back_after_an_exception_and_a_close(
        tiny, monkeypatch, caller_flags, compute_dtype, end):
    """A run that raises mid-sampling, and one closed by its caller after
    its first frame, put the caller's flags back and release the lock."""
    events = []
    lock = _Lock(events)
    kw = dict(KW, compute_dtype=compute_dtype, prefix_path=tiny / "o", device_lock=lock)
    if end == "exception":
        boom = ValueError("boom")
        monkeypatch.setattr(api, "sample_loop",
                            _loop_raising_after_one_frame(api.sample_loop, boom))
        with pytest.raises(ValueError, match="boom"):
            list(api.clip_guided_diffusion(**kw))
    else:
        gen = api.clip_guided_diffusion(**kw)
        next(gen)
        assert lock.held
        gen.close()
    assert events == ["acquire", ("release", (True, True))]
    assert not lock.held and _flags() == (True, True)


@pytest.mark.parametrize("f32", [False, True], ids=["bfloat16", "float32"])
def test_the_device_hold_pets_while_queued_and_is_idempotent(caller_flags, f32):
    """``take`` pets once before its first try and after each failed one,
    then holds; a second ``take`` and a second ``release`` do nothing;
    ``suspended`` lends the caller's flags; ``release`` puts the flags back
    before it releases the lock."""
    events = []
    lock = _Lock(events, busy=2)
    hold = api._DeviceHold(lock, f32, events.append)
    hold.take()
    hold.take()
    off = (not f32, not f32)
    assert events == ["waiting for device lock"] * 3 + ["acquire"] and _flags() == off
    with hold.suspended():
        assert _flags() == (True, True)
    assert _flags() == off
    hold.release()
    hold.release()
    assert events[4:] == [("release", (True, True))] and not lock.held


def test_the_waiting_pet_arrives_while_another_run_holds_the_lock():
    """With a real lock held by another thread, the pet comes while it is
    held; the hold gets the lock once the other thread lets it go."""
    lock, pets = threading.Lock(), []
    lock.acquire()
    other = threading.Timer(0.2, lock.release)

    def pet(phase):
        pets.append((phase, lock.locked()))
        if len(pets) == 1:
            other.start()

    hold = api._DeviceHold(lock, False, pet)
    hold.take()
    other.join()
    assert pets == [("waiting for device lock", True)] and hold.held and lock.locked()
    hold.release()
    assert not lock.locked()
