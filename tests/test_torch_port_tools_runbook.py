"""The port's quality tools on the CPU: ``cgd_tpu_torch/tools/clip_score.py``
and ``first_real_run.py``.

- clip_score's scores against the JAX tool's body (``tools/clip_score.py``:
  Pillow's crop and ``Image.BICUBIC`` resize, ``cgd_tpu``'s
  ``encode_image`` / ``encode_text``) on the same toy CLIP weights (carried
  by ``convert/from_jax.py``) and the same PNGs, a square one and two that
  are cut to their centre square: within 1e-3 (scores are 100 x a cosine;
  f32 towers summing in other orders);
- the port's parameter counts against the JAX runbook's ``_count_params``
  of ``jax.eval_shape(init_...)`` at the full 64px UNet, ViT-B/32 and the
  LPIPS VGG16: equal (the port's modules built on the meta device, so
  neither side computes anything);
- ``first_real_run --dry-run --device cpu``: the report's phases are the
  JAX runbook's (tests/test_io_misc.py's set), one frame scored.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.io_utils.images import encode_png  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402
from cgd_tpu_torch.tools import clip_score, first_real_run  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PROMPT = "a watercolor painting of a lighthouse"


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_params(init, seed):
    rs = np.random.RandomState(seed)

    def draw(path, s):
        if len(s.shape) <= 1:
            base = 1.0 if "scale" in str(path[-1]) else 0.0
            return jnp.asarray(base + 0.05 * rs.randn(*s.shape).astype(np.float32))
        return jnp.asarray(rs.randn(*s.shape).astype(np.float32) / np.sqrt(np.prod(s.shape[:-1])))

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


@pytest.fixture(scope="module")
def toy_clip():
    jcfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["ViT-B/32"], vision=jconfigs.VisionViTConfig(32, 8, 32, 2, 2),
        text=jconfigs.TextConfig(77, 64, 32, 2, 1), embed_dim=16)
    tcfg = tconfigs.CLIPConfig(jcfg.name, 16, tconfigs.VisionViTConfig(32, 8, 32, 2, 2),
                               tconfigs.TextConfig(77, 64, 32, 2, 1))
    params = _numpy_params(lambda: jclip.init_clip(jax.random.PRNGKey(0), jcfg), 0)
    return jcfg, params, tcfg, load_from_jax(tclip.CLIP(tcfg), params)


def _pngs(tmp_path):
    rs = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate(((48, 48), (40, 61), (75, 50))):
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        rgb = np.stack([xx, yy, xx * yy], -1) * 200 + rs.rand(h, w, 3) * 55
        path = tmp_path / f"im{i}.png"
        path.write_bytes(encode_png(rgb.astype(np.uint8)))
        paths.append(str(path))
    return paths


def test_clip_score_matches_the_jax_tools_body(toy_clip, tmp_path):
    from PIL import Image

    from cgd_tpu.api import _FallbackTokenizer

    jcfg, params, tcfg, model = toy_clip
    paths = _pngs(tmp_path)
    res = jcfg.input_resolution
    # the JAX tool's body (tools/clip_score.py:55-76)
    tokens = _FallbackTokenizer(jcfg.text.vocab_size).tokenize([PROMPT])
    tfeat = np.asarray(jclip.encode_text(params, jcfg, jnp.asarray(tokens)))
    tfeat = tfeat / np.linalg.norm(tfeat, axis=-1, keepdims=True)
    ims = []
    for path in paths:
        im = Image.open(path).convert("RGB")
        side = min(im.size)
        left, top = (im.size[0] - side) // 2, (im.size[1] - side) // 2
        im = im.crop((left, top, left + side, top + side)).resize((res, res), Image.BICUBIC)
        arr = np.asarray(im, np.float32) / 255.0
        ims.append((arr - np.asarray(jconfigs.CLIP_MEAN, np.float32))
                   / np.asarray(jconfigs.CLIP_STD, np.float32))
    ifeat = np.asarray(jclip.encode_image(params, jcfg, jnp.asarray(np.stack(ims))))
    ifeat = ifeat / np.linalg.norm(ifeat, axis=-1, keepdims=True)
    want = 100.0 * (ifeat @ tfeat.T)[:, 0]

    from cgd_tpu_torch.io_utils.images import decode_image

    batch = np.stack([clip_score.prepare(decode_image(p), res) for p in paths])
    np.testing.assert_allclose(batch, np.stack(ims), atol=1e-6)  # Pillow's pixels exactly
    got = clip_score.scores(model, clip_score.tokenize(PROMPT, tcfg, "random"), batch)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert np.ptp(want) > 1e-2  # the images score apart


def test_clip_score_command_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    paths = _pngs(tmp_path)[:2]
    clip_score.main(["--prompt", PROMPT, "--weights-mode", "random", "--device", "cpu", *paths])
    out = capsys.readouterr()
    rec = json.loads(out.out.strip().splitlines()[-1])
    assert rec["n"] == 2 and rec["prompt"] == PROMPT and rec["clip_model"] == "ViT-B/32"
    assert set(rec) == {"prompt", "clip_model", "n", "mean_clip_score", "std"}
    assert all(p in out.err for p in paths)


@pytest.mark.parametrize("which", ["unet_64", "clip_vit_b32", "lpips_vgg"])
def test_parameter_counts_equal_the_jax_runbooks(which):
    from cgd_tpu.models import unet as junet
    from cgd_tpu.models import vgg_lpips as jlpips
    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    key = jax.random.PRNGKey(0)
    if which == "unet_64":
        flags = dict(DIFFUSION_LOOKUP["cond"][64]["model_flags"])
        shapes = jax.eval_shape(lambda: junet.init_unet(key, junet.UNetConfig.from_flags(flags)))
        ours = UNet(UNetConfig.from_flags(flags), device="meta")
        floor = first_real_run.FLOORS["resolve_unet_64"]
    elif which == "clip_vit_b32":
        shapes = jax.eval_shape(lambda: jclip.init_clip(key, jconfigs.CLIP_CONFIGS["ViT-B/32"]))
        ours = tclip.CLIP(tconfigs.CLIP_CONFIGS["ViT-B/32"], device="meta")
        floor = first_real_run.FLOORS["resolve_clip_vit_b32"]
    else:
        shapes = jax.eval_shape(lambda: jlpips.init_vgg_lpips(key))
        ours = VGGLPIPS(device="meta")
        floor = first_real_run.FLOORS["resolve_lpips_vgg"]
    want = _jax_tool("first_real_run")._count_params(shapes)
    assert first_real_run.count_params(ours) == want
    assert want > floor  # the published models pass the runbook's floors


def test_first_real_run_dry_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the clip_score subprocess's torch threads
    monkeypatch.chdir(tmp_path)  # the API writes current.png beside its frames
    report = first_real_run.run(True, str(tmp_path / "o"), device="cpu")
    assert report == json.loads((tmp_path / "o" / "first_real_run_report.json").read_text())
    assert set(report["phases"]) == {
        "resolve_unet_64", "resolve_clip_vit_b32", "resolve_lpips_vgg", "cache_hit",
        "acceptance_config_1", "clip_score"}
    assert report["device"] == {"torch": "cpu", "name": "cpu"} and report["mode"] == "random"
    assert report["parity_table"]["cgd_tpu_torch_clip_score"]["n"] == 1
    assert report["phases"]["acceptance_config_1"]["frames"] == 6  # steps 0, 5, ..., 20, 24


def test_first_real_run_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        first_real_run.run(True, str(tmp_path), device="cuda")
