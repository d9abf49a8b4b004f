"""Batch > 1 in the port on the CPU.

The guided step at ``batch_size=3`` against cgd_tpu's on the same weights,
the same injected noise and cutout coordinates (tolerance as
tests/test_torch_port_step.py: atol 1e-4 of the reference's max plus rtol
1e-4), and each image of the batch against its lone step (the losses are
sums of per-image terms, the cutouts are shared; the saturation loss, a mean over
the whole batch as in the reference, and ``use_magnitude`` are off there;
same bound). ``randomize_class`` draws a label
per image. The CLI's ``-bs 2`` writes each image under its batch index, and
a served ``batch_size: 2`` request streams both images. The launch plans
leave split K as the batch fills the card (``conv_plan`` / ``f32_plan``).
The kernels themselves at b > 1 are card checks
(tests/test_torch_port_batch_cuda.py, chip_smoke.py phase 14a).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.diffusion import sampler as jsampler  # noqa: E402
from cgd_tpu_torch import cli as tcli  # noqa: E402
from cgd_tpu_torch.diffusion import gaussian as tgauss  # noqa: E402
from cgd_tpu_torch.diffusion import sampler as tsampler  # noqa: E402
from cgd_tpu_torch.guidance import pipeline as tpipe  # noqa: E402
from cgd_tpu_torch.guidance.cutouts import CutoutSpec  # noqa: E402
from cgd_tpu_torch.io_utils.images import clean_and_combine_prompts  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402
from test_torch_port_serve import PNG, REQ, _parts, _post, server  # noqa: E402,F401
from test_torch_port_step import CUTN, SIZE, _close, _pair, models  # noqa: E402,F401

torch.set_num_threads(2)

B = 3
LABELS = [3, 1, 5]


def _draws(seed=5):
    rs = np.random.RandomState(seed)
    size = np.array([20.0, 32.0, 17.0, 25.0], np.float32)
    coords = (np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32),
              np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32), size)
    return dict(x=rs.randn(B, SIZE, SIZE, 3).astype(np.float32),
                noise=rs.randn(1, B, SIZE, SIZE, 3).astype(np.float32), coords=coords,
                targets=rs.randn(2, 16).astype(np.float32),
                weights=np.array([0.75, 0.25], np.float32))


def _port_step(models, d, use_ddim, lo, hi):
    *_, tdiff, tb, tcfg, tmodel = _pair(models, d, "ddim25" if use_ddim else "25", use_ddim)
    step = tsampler.make_guided_step(tdiff, tmodel, tb(tsampler.StepMeta(17, True, CUTN)), tcfg)
    x_next, pred, y, log = step(torch.from_numpy(d["x"][lo:hi]), 17, 20,
                                torch.tensor(LABELS[lo:hi]), torch.Generator().manual_seed(0),
                                noise_override=torch.from_numpy(d["noise"][0][lo:hi]))
    return x_next, pred, y


@pytest.mark.parametrize("use_ddim", [True, False], ids=["ddim", "ancestral"])
def test_the_guided_step_at_batch_3_matches_jax(models, use_ddim):
    d = _draws()
    jdiff, jb, jcfg, jmodel, *_ = _pair(models, d, "ddim25" if use_ddim else "25", use_ddim)
    meta = jsampler.StepMeta(t=17, guided=True, cutn=CUTN)
    jstep = jax.jit(jsampler.make_guided_step(jdiff, jmodel, jb(meta), jcfg))
    x_ref, pred_ref, _ = jstep(models["jparams"], jnp.asarray(d["x"]), 17, 20,
                               jnp.asarray(LABELS), jax.random.PRNGKey(0),
                               noise_override=jnp.asarray(d["noise"][0]))
    x_next, pred, y = _port_step(models, d, use_ddim, 0, B)
    assert y.tolist() == LABELS and x_next.shape == (B, SIZE, SIZE, 3)
    _close(pred, pred_ref, "pred_xstart")
    _close(x_next, x_ref, "x_next")


@pytest.mark.parametrize("use_ddim", [True, False], ids=["ddim", "ancestral"])
def test_each_image_of_a_batch_is_its_lone_step(models, use_ddim):
    d = _draws(seed=6)
    diff = tgauss.make_diffusion(steps=1000, timestep_respacing="ddim25" if use_ddim else "25")
    builder = tpipe.make_guidance_builder(
        models["clip"], models["tccfg"], torch.from_numpy(d["targets"]),
        torch.from_numpy(d["weights"]), diff,
        tpipe.GuidanceSettings(clip_guidance_scale=1000.0, tv_scale=150.0, range_scale=50.0,
                               clip_compute_dtype="float32"),
        cached_coords=CutoutSpec(*(torch.from_numpy(c) for c in d["coords"])))
    step = tsampler.make_guided_step(diff, lambda x, t, y: models["unet"](x, t, y),
                                     builder(tsampler.StepMeta(17, True, CUTN)),
                                     tsampler.SamplerConfig(use_ddim=use_ddim))

    def run(lo, hi):
        return step(torch.from_numpy(d["x"][lo:hi]), 17, 20, torch.tensor(LABELS[lo:hi]),
                    torch.Generator().manual_seed(0),
                    noise_override=torch.from_numpy(d["noise"][0][lo:hi]))[:2]

    x_next, pred = run(0, B)
    for i in range(B):
        x_i, pred_i = run(i, i + 1)
        _close(pred[i:i + 1], pred_i.numpy(), f"pred_xstart of image {i}")
        _close(x_next[i:i + 1], x_i.numpy(), f"x_next of image {i}")


def test_randomize_class_draws_a_label_per_image(models):
    d = _draws()
    *_, tdiff, tb, _, tmodel = _pair(models, d, "ddim25", True)
    step = tsampler.make_guided_step(
        tdiff, tmodel, None, tsampler.SamplerConfig(use_ddim=True, randomize_class=True,
                                                    num_classes=10))
    y = torch.zeros(8, dtype=torch.long)
    x = torch.from_numpy(np.concatenate([d["x"]] * 3)[:8])
    _, _, y_next, _ = step(x, 17, 20, y, torch.Generator().manual_seed(1))
    assert y_next.shape == (8,) and len(set(y_next.tolist())) > 1


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_the_cli_writes_each_image_under_its_batch_index(tiny):
    tcli.main(["--prompts", "a batch", "-size", "64", "-cutn", "2", "-respace", "ddim5",
               "-bs", "2", "-freq", "2", "--weights-mode", "random", "--device", "cpu",
               "--compute-dtype", "float32", "-q", "-dir", str(tiny / "out")])
    for i in range(2):
        frame_dir = Path(clean_and_combine_prompts(tiny / "out", ["a batch"], i))
        frames = sorted(p.name for p in frame_dir.glob("*.png"))
        assert frames == ["0000.png", "0002.png", "0004.png"], (i, frames)


def test_a_served_batch_of_2_streams_both_images(server):
    ctype, body = _post(server, dict(REQ, prompt="two", batch_size=2, stream=True,
                                     save_frequency=2))
    pngs = [p for p in _parts(body) if b"Content-Type: image/png" in p]
    assert len(pngs) == 2 * 3  # steps 0, 2 and the final frame 4, two images each
    for p in pngs:
        assert p.split(b"\r\n\r\n", 1)[1][:8] == PNG
    assert len({p.split(b"\r\n\r\n", 1)[1] for p in pngs}) == 6  # no frame repeated


# ---- the plans at b > 1 -------------------------------------------------------

# (H = W, Cin, Cout): the 256px model's 16^2 and 8^2 levels, which split K at b = 1
SPLIT_LEVELS = [(16, 2048, 1024), (8, 1024, 1024)]


@pytest.mark.parametrize("h,cin,cout", SPLIT_LEVELS)
def test_split_k_shrinks_as_the_batch_fills_the_card(h, cin, cout):
    """tiles = patches * N tiles * b: once b * tiles reaches the 132 SMs, no
    split. The f32 body's 64-wide N tiles reach it by b = 8 at both levels;
    the bf16 body's 256-wide tiles at b = 17 (16^2) and b = 33 (8^2)."""
    bf16 = [k3.conv_plan(b, h, h, cin, cout)["ksplit"] for b in (1, 2, 4, 8, 17, 33)]
    f32 = [k3.f32_plan(b, h, h, cin, cout)["ksplit"] for b in (1, 2, 4, 8)]
    assert bf16 == sorted(bf16, reverse=True) and bf16[0] > 1
    assert f32 == sorted(f32, reverse=True) and f32[0] > 1 and f32[-1] == 1
    first = next(b for b in range(1, 64) if k3.conv_plan(b, h, h, cin, cout)["ksplit"] == 1)
    plan = k3.conv_plan(first, h, h, cin, cout)
    patches, ntiles = plan["grid"][0], plan["grid"][1]
    assert first == -(-132 // (patches * ntiles)) == (17 if h == 16 else 33)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("h,cin,cout", SPLIT_LEVELS + [(256, 256, 256), (512, 128, 128)])
def test_a_batch_plan_is_the_lone_plan_on_more_images(b, h, cin, cout):
    """The per-image geometry does not change with b (patch, N tile, window,
    TMA boxes); grid z = b * ksplit (bf16) and the tile grid's third axis
    b * ksplit (f32) count the images; the f32 workspace and K-dx's dA / dB
    partial rows are sized per image."""
    one, many = k3.conv_plan(1, h, h, cin, cout), k3.conv_plan(b, h, h, cin, cout)
    for key in ("patch", "bn", "bk", "chunks", "window", "box_x", "box_w", "smem_bytes"):
        assert many[key] == one[key], key
    assert many["grid"][:2] == one["grid"][:2] and many["grid"][2] == b * many["ksplit"]
    # the image stride of the TMA map: one image of the padded input
    assert many["strides_x"][2] == h * h * many["cin"] * 2
    f1, fb = k3.f32_plan(1, h, h, cin, cout, dx=True), k3.f32_plan(b, h, h, cin, cout, dx=True)
    for key in ("patch", "bn", "k8_steps", "window", "slot", "partial_rows", "wsplit"):
        assert fb[key] == f1[key], key
    assert fb["tile_grid"] == (f1["tile_grid"][0], f1["tile_grid"][1], b * fb["ksplit"])
    assert fb["ws_floats"] == (fb["ksplit"] * b * h * h * fb["cout"] if fb["ksplit"] > 1 else 0)
