"""The port's CLI (cgd_tpu_torch/cli.py) against cgd_tpu/cli.py: the same
parser (spellings and defaults; only --device differs, cuda), the same flag
-> keyword mapping onto clip_guided_diffusion, refusals by flag name for
what the port cannot honour, and toy-size runs on the CPU, one of them the
init-image path from reference-layout checkpoints
(tests/torch_port_toy_checkpoints.py)."""

import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgd_tpu import cli as jcli  # noqa: E402
from cgd_tpu_torch import api as tapi  # noqa: E402
from cgd_tpu_torch import cli as tcli  # noqa: E402
from cgd_tpu_torch.io_utils.images import encode_png  # noqa: E402
from tests import torch_port_toy_checkpoints as toy  # noqa: E402

torch.set_num_threads(2)


def _options(parser):
    return {tuple(a.option_strings): a.dest for a in parser._actions if a.option_strings}


def test_parser_matches_the_jax_cli():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert _options(tp) == _options(jp)
    jd, td = vars(jp.parse_args([])), vars(tp.parse_args([]))
    assert td.pop("device") == "cuda" and jd.pop("device") == ""
    assert td == jd
    for action in tp._actions:  # the same choices where the JAX CLI has them
        if action.choices:
            assert action.choices == jp._option_string_actions[action.option_strings[0]].choices


@pytest.fixture
def recorded(monkeypatch, tmp_path):
    """Replace the API with a recorder; returns the kwargs of the last call."""
    calls = []

    def fake(**kwargs):
        calls.append(kwargs)
        yield 0, "frame.png"

    monkeypatch.setattr(tapi, "clip_guided_diffusion", fake)
    monkeypatch.chdir(tmp_path)
    return calls


def test_flags_map_to_api_keywords(recorded):
    tcli.main(["--prompts", "a lighthouse:1|fog:0.5", "-size", "512", "-clip", "RN50x16",
               "-cutn", "16", "-respace", "ddim25", "--weights-mode", "random", "-freq", "12",
               "-cgs", "1500", "-tvs", "150", "-rs", "40", "-sats", "2", "-seed", "7",
               "-steps", "500", "-cutpow", "0.5", "-sched", "cosine", "-bs", "2", "-mag",
               "-cached_cutn", "-q", "-dir", "out", "--compute-dtype", "float32"])
    (kw,) = recorded
    assert kw["prompts"] == ["a lighthouse:1", "fog:0.5"]
    want = dict(image_size=512, clip_model_name="RN50x16", num_cutouts=16,
                timestep_respacing="ddim25", weights_mode="random", save_frequency=12,
                clip_guidance_scale=1500.0, tv_scale=150.0, range_scale=40.0, sat_scale=2.0,
                seed=7, diffusion_steps=500, cutout_power=0.5, noise_schedule="cosine",
                batch_size=2, use_magnitude=True, cached_cutouts=True, progress=False,
                compute_dtype="float32", device="cuda", class_cond=True, randomize_class=True,
                prefix_path=Path("out"))
    assert {k: kw[k] for k in want} == want
    assert Path("out").is_dir()


def test_uncond_turns_off_class_conditioning_and_class_randomizing(recorded):
    tcli.main(["--prompts", "x", "--uncond", "--device", "cpu"])
    (kw,) = recorded
    assert kw["class_cond"] is False and kw["randomize_class"] is False
    assert kw["device"] == "cpu"


@pytest.mark.parametrize("argv,flag", [
    (["-augs"], "--use_augs"), (["-gif"], "--save-as-gif"), (["-mp4"], "--save-as-video"),
    (["--profile", "p"], "--profile"),
    (["--log-losses"], "--log-losses"), (["--fast-guidance"], "--fast-guidance"),
    (["--dpm-solver"], "--dpm-solver"), (["--checkpoint", "c.npz"], "--checkpoint"),
    (["--resume", "c.npz"], "--resume"), (["--stall-timeout", "5"], "--stall-timeout"),
])
def test_flags_the_port_cannot_honour_raise_by_name(recorded, argv, flag):
    with pytest.raises(NotImplementedError, match=flag):
        tcli.main(["--prompts", "x", *argv])
    assert recorded == []


@pytest.mark.parametrize("argv,want", [
    (["-imgs", "a.png|https://x/b.png:0.5"], {"image_prompts": ["a.png", "https://x/b.png:0.5"]}),
    (["-init", "a.png", "-skip", "12", "-is", "1000"],
     {"init_image": "a.png", "skip_timesteps": 12, "init_scale": 1000}),
    (["--no-strict-parity"], {"strict_parity": False}),
], ids=["-imgs", "-init", "--no-strict-parity"])
def test_init_image_flags_reach_the_api(recorded, argv, want):
    """As the JAX CLI: '|'-separated image prompts, the init image with its
    skip and LPIPS scale, and --no-strict-parity go to the API."""
    tcli.main(["--prompts", "x", *argv])
    (kw,) = recorded
    assert {k: kw[k] for k in want} == want
    defaults = dict(image_prompts=[], init_image="", skip_timesteps=0, init_scale=0,
                    strict_parity=True)
    assert {k: kw[k] for k in defaults if k not in want} == {
        k: v for k, v in defaults.items() if k not in want}


def test_options_the_api_refuses_raise_through_the_cli(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="reduce_clip"):
        tcli.main(["--prompts", "x", "-reduce", "--device", "cpu", "--weights-mode", "random"])


@pytest.mark.parametrize("argv,keyword", [(["-ckpts", "ckpts"], "checkpoints_dir"),
                                          (["-ent", "team"], "wandb_entity")])
def test_checkpoint_dir_and_wandb_entity_reach_the_api(monkeypatch, tmp_path, argv, keyword):
    """As the JAX CLI, ``-ckpts`` and ``-ent`` go to the API (they were
    dropped silently once): ``-ckpts`` is where ``--weights-mode auto``
    finds the reference-layout checkpoints and writes their converted
    caches; ``-ent`` the API refuses by name. The defaults and ``-drop``
    pass."""
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    argv_run = ["--prompts", "x", *argv, "-size", "64", "-cutn", "2", "-respace", "ddim5",
                "--device", "cpu", "--compute-dtype", "float32", "-q"]
    if keyword == "wandb_entity":
        with pytest.raises(NotImplementedError, match=keyword):
            tcli.main(argv_run + ["--weights-mode", "random"])
        return
    toy.install(monkeypatch, tmp_path, tmp_path / "ckpts")
    tcli.main(argv_run + ["--weights-mode", "auto", "-freq", "2"])
    assert (tmp_path / "ckpts" / "toy_unet.pt.npz.cgd").is_file()
    assert (tmp_path / "ckpts" / "clip" / "ViT-B-32.pt.npz.cgd").is_file()
    assert len(list((tmp_path / "outputs").rglob("*.png"))) == 3


def test_the_init_image_path_from_checkpoints_through_the_cli(monkeypatch, tmp_path):
    """The tentpole's command line at toy size: reference-layout UNet, CLIP
    and VGG / lpips weights converted from -ckpts (the LPIPS .pth files from
    the download cache), an init image with skip and init scale, an image
    prompt; ddim5 with skip 2 leaves three steps, saved at 0 and 2 with
    -freq 2."""
    monkeypatch.chdir(tmp_path)
    toy.install(monkeypatch, tmp_path, tmp_path / "ckpts", lpips=True)
    rs = np.random.RandomState(0)
    for name, shape in (("init.png", (70, 64, 3)), ("style.png", (40, 52, 3))):
        (tmp_path / name).write_bytes(encode_png(rs.randint(0, 256, shape).astype(np.uint8)))
    tcli.main(["--prompts", "the hello", "-init", "init.png", "-skip", "2", "-is", "1000",
               "-imgs", "style.png:0.5", "-size", "64", "-cutn", "2", "-respace", "ddim5",
               "-ckpts", "ckpts", "--weights-mode", "auto", "--device", "cpu",
               "--compute-dtype", "float32", "-freq", "2", "-q"])
    assert (tmp_path / "ckpts" / "lpips_vgg.npz.cgd").is_file()
    pngs = sorted(p.name for p in (tmp_path / "outputs").rglob("*.png"))
    assert pngs == ["0000.png", "0002.png"]


def test_dropout_and_the_default_checkpoint_dir_pass_to_the_api(recorded):
    tcli.main(["--prompts", "x", "-drop", "0.25"])
    (kw,) = recorded
    assert kw["dropout"] == 0.25 and kw["wandb_entity"] is None
    assert kw["checkpoints_dir"] == tapi.CACHE_PATH


def test_tiny_run_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    tcli.main(["--prompts", "a red cube", "-size", "64", "-cutn", "2", "-respace", "ddim5",
               "--weights-mode", "random", "--device", "cpu", "--compute-dtype", "float32",
               "-freq", "2", "-q"])
    pngs = sorted(p.name for p in (tmp_path / "outputs").rglob("*.png"))
    assert len(pngs) == 3  # steps 0, 2 and the final frame
    with open(tmp_path / "current.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--prompts", "x", "--weights-mode", "random"])
    assert os.path.isdir(tmp_path / "outputs")
