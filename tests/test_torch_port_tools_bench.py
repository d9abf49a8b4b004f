"""The port's measuring tools ``cgd_tpu_torch/tools/bench.py`` and
``time_components.py`` on the CPU, at toy size.

- ``guided_step_flops`` (the FLOPs of one guided step, counted from the
  models' shapes) against ``torch.utils.flop_counter.FlopCounterMode`` over
  one step of the bench's own step under ``kernel_routing("plain")``:
  exactly equal, per op family, with and without fast guidance, ViT and
  ModifiedResNet towers, batch 1 and 2;
- one bench step against one step built as the JAX bench builds it
  (``bench.py``: ``GuidanceSettings()``, one ``RandomState(2)`` target at
  weight 1, ``StepMeta(t=0, guided=True, cutn)``) on the same weights
  (carried by ``convert/from_jax.py``), in f32, with the cutout coordinates
  and the step noise injected on both sides and ``randomize_class`` off:
  x_next and pred_xstart within atol 1e-4 x max|reference| + rtol 1e-4, the
  f32 guided-step tolerance of tests/test_torch_port_step.py (the guidance
  scale of 1000 amplifies f32 rounding in the backward);
- the bench's and time_components' command lines at toy size on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.diffusion import gaussian as jgauss  # noqa: E402
from cgd_tpu.diffusion import sampler as jsampler  # noqa: E402
from cgd_tpu.guidance import pipeline as jpipe  # noqa: E402
from cgd_tpu.guidance.cutouts import CutoutSpec as JSpec  # noqa: E402
from cgd_tpu.models import unet as junet  # noqa: E402
from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.diffusion import gaussian as tgauss  # noqa: E402
from cgd_tpu_torch.guidance.cutouts import CutoutSpec as TSpec  # noqa: E402
from cgd_tpu_torch.models import unet as tunet  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402
from cgd_tpu_torch.ops.nn import kernel_routing  # noqa: E402
from cgd_tpu_torch.tools import bench, time_components  # noqa: E402

torch.set_num_threads(2)

SIZE, CUTN, CLIP_RES = 32, 4, 16
UKW = dict(image_size=SIZE, model_channels=32, num_res_blocks=1, attention_ds=(2,),
           channel_mult=(1, 2), num_head_channels=16)
TEXT = tconfigs.TextConfig(context_length=8, vocab_size=50, width=32, heads=2, layers=1)
VIT = tconfigs.CLIPConfig("toy-vit", 16, tconfigs.VisionViTConfig(CLIP_RES, 8, 32, 2, 2), TEXT)
RESNET = tconfigs.CLIPConfig("toy-rn", 16, tconfigs.VisionResNetConfig(64, 8, (1, 2, 1, 1), 2),
                             TEXT)


class _Global:
    """FlopCounterMode's module tracker hooks the backward of every module
    output, which ``torch.autograd.grad`` refuses; the guided step's
    gradient is one, so the counts are taken globally only."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _counted_step(unet_cfg, clip_cfg, batch, cutn, fast):
    from torch.utils.flop_counter import FlopCounterMode

    gen = torch.Generator().manual_seed(0)
    unet = tunet.UNet(unet_cfg, device="cpu").init_weights(gen)
    clip = tclip.CLIP(clip_cfg, device="cpu").init_weights(gen)
    diffusion = tgauss.make_diffusion(1000, "linear", "ddim10")
    step = bench.make_step(unet, clip, clip_cfg, diffusion, cutn, True, fast, False,
                           torch.float32)
    x = torch.randn(batch, unet_cfg.image_size, unet_cfg.image_size, 3, generator=gen)
    fc = FlopCounterMode(display=False)
    fc.mod_tracker = _Global()
    with kernel_routing("plain"), fc:
        step(x, 5, 5, torch.zeros(batch, dtype=torch.long), torch.Generator().manual_seed(1))
    by_op = {"matmul": 0, "convolution": 0, "convolution_backward": 0}
    for op, n in fc.get_flop_counts()["Global"].items():
        name = str(op).removeprefix("aten.")
        by_op["matmul" if name in ("mm", "bmm", "addmm", "baddbmm") else name] += n
    return fc.get_total_flops(), by_op


@pytest.mark.parametrize("clip_cfg,batch,cutn,fast", [
    (VIT, 1, 4, False), (VIT, 1, 4, True), (VIT, 2, 3, False), (RESNET, 1, 2, False)],
    ids=["vit", "vit-fast", "vit-b2", "resnet"])
def test_guided_step_flops_equal_the_flop_counter(clip_cfg, batch, cutn, fast):
    unet_cfg = tunet.UNetConfig(**UKW, num_classes=1000)
    total, by_op = _counted_step(unet_cfg, clip_cfg, batch, cutn, fast)
    want, want_by_op = bench.guided_step_flops(unet_cfg, clip_cfg, SIZE, batch, cutn, fast,
                                               breakdown=True)
    assert by_op == want_by_op, f"by op: counted {by_op}, analytic {want_by_op}"
    assert total == want
    if fast:  # no UNet backward; the ViT tower has no convolution
        assert by_op["convolution_backward"] == 0


def test_the_256px_step_count():
    """The 256px ViT-B/32 point of the smoke run: the UNet backward doubles
    its convolutions, fast guidance drops them."""
    from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    cfg = tunet.UNetConfig.from_flags(dict(DIFFUSION_LOOKUP["cond"][256]["model_flags"]))
    full, by_op = bench.guided_step_flops(cfg, CLIP_CONFIGS["ViT-B/32"], 256, 1, 16, False,
                                          breakdown=True)
    fast, fast_by_op = bench.guided_step_flops(cfg, CLIP_CONFIGS["ViT-B/32"], 256, 1, 16, True,
                                               breakdown=True)
    assert by_op["convolution"] == by_op["convolution_backward"] == fast_by_op["convolution"]
    assert fast_by_op["convolution_backward"] == 0 and 4e12 < full < 6e12 and fast < full
    assert bench.guided_step_flops(cfg, CLIP_CONFIGS["ViT-B/32"], 256, 2, 16, False) > full


def test_the_peak_is_keyed_on_the_card():
    assert bench.bf16_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.bf16_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert bench.bf16_peak_flops("NVIDIA A100-SXM4-80GB") is None


# ---------------------------------------------------------------------------
# one bench step against the JAX bench's
# ---------------------------------------------------------------------------

def _numpy_params(init, seed):
    """Weights of ``init``'s shapes from numpy (no eager JAX init): norm
    scales 1 + N(0, 0.05^2), other vectors N(0, 0.05^2), matrices and
    kernels N(0, 1 / fan_in) (every zero-init layer drawn too)."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        if len(s.shape) <= 1:
            base = 1.0 if str(path[-1]).find("scale") >= 0 else 0.0
            return jnp.asarray(base + 0.05 * rs.randn(*s.shape).astype(np.float32))
        fan_in = int(np.prod(s.shape[:-1]))
        return jnp.asarray(rs.randn(*s.shape).astype(np.float32) / np.sqrt(fan_in))

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


@pytest.fixture(scope="module")
def models():
    jucfg = junet.UNetConfig(**UKW, num_classes=10)
    uparams = _numpy_params(lambda: junet.init_unet(jax.random.PRNGKey(0), jucfg), 0)
    jccfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["ViT-B/32"],
        vision=jconfigs.VisionViTConfig(*dataclasses.astuple(VIT.vision)),
        text=jconfigs.TextConfig(*dataclasses.astuple(TEXT)), embed_dim=16)
    cparams = _numpy_params(lambda: jclip.init_clip(jax.random.PRNGKey(1), jccfg), 1)
    return dict(jucfg=jucfg, jccfg=jccfg, jparams={"unet": uparams, "clip": cparams},
                unet=load_from_jax(tunet.UNet(tunet.UNetConfig(**UKW, num_classes=10)), uparams),
                clip=load_from_jax(tclip.CLIP(VIT), cparams))


def _close(ours, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()), err_msg=what)


@pytest.mark.parametrize("respace,fast,dpm", [("ddim25", False, False), ("ddim25", True, False),
                                              ("ddim25", False, True)], ids=["ddim", "fast", "dpm"])
def test_one_bench_step_matches_the_jax_bench_step(models, respace, fast, dpm):
    rs = np.random.RandomState(3)
    size = np.array([20.0, 32.0, 17.0, 25.0], np.float32)
    coords = (np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32),
              np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32), size)
    x = rs.randn(1, SIZE, SIZE, 3).astype(np.float32)
    noise = rs.randn(1, SIZE, SIZE, 3).astype(np.float32)
    x0p = rs.randn(1, SIZE, SIZE, 3).astype(np.float32)
    use_ddim = respace.startswith("ddim")
    t, ref_t, t_prev = 17, 17, 18

    # the JAX bench's step (bench.py:116-150) at f32, coordinates injected
    jdiff = jgauss.make_diffusion(1000, "linear", respace)
    target = np.random.RandomState(2).randn(1, 16).astype(np.float32)
    jbuilder = jpipe.make_guidance_builder(
        models["jccfg"], target, np.ones((1,), np.float32), jdiff,
        jpipe.GuidanceSettings(clip_compute_dtype="float32"), cached_coords=JSpec(*coords))
    jucfg = models["jucfg"]

    def jmodel(params, x_, t_model, rng, y):
        return junet.apply_unet(params["unet"], jucfg, x_, t_model, y)

    jstep = jax.jit(jsampler.make_guided_step(
        jdiff, jmodel, jbuilder(jsampler.StepMeta(t=0, guided=True, cutn=CUTN)),
        jsampler.SamplerConfig(use_ddim=use_ddim, randomize_class=False, fast_guidance=fast,
                               dpm_solver=dpm)))
    y = jnp.asarray([3])
    if dpm:
        jx, jpred, _, _ = jstep(models["jparams"], jnp.asarray(x), t, ref_t, y,
                                jax.random.PRNGKey(0),
                                dpm_state=(jnp.asarray(x0p), jnp.int32(t_prev), jnp.asarray(False)))
    else:
        jx, jpred, _ = jstep(models["jparams"], jnp.asarray(x), t, ref_t, y,
                             jax.random.PRNGKey(0), noise_override=jnp.asarray(noise))

    tdiff = tgauss.make_diffusion(1000, "linear", respace)
    step = bench.make_step(models["unet"], models["clip"], VIT, tdiff, CUTN, use_ddim, fast, dpm,
                           torch.float32, randomize_class=False,
                           cached_coords=TSpec(*(torch.from_numpy(c) for c in coords)))
    gen = torch.Generator().manual_seed(0)
    if dpm:
        tx, tpred, *_ = step(torch.from_numpy(x), t, ref_t, torch.tensor([3]), gen,
                             dpm_state=(torch.from_numpy(x0p), t_prev, False))
    else:
        tx, tpred, *_ = step(torch.from_numpy(x), t, ref_t, torch.tensor([3]), gen,
                             noise_override=torch.from_numpy(noise))
    _close(tpred, jpred, "pred_xstart")
    _close(tx, jx, "x_next")


# ---------------------------------------------------------------------------
# the command lines, toy models on the CPU
# ---------------------------------------------------------------------------

def test_bench_record_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    bench.main(["--size", "64", "--respace", "ddim2", "--cutn", "2", "--dpm",
                "--device", "cpu", "--stall-timeout", "0"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["metric"] == "64px_ddim2_dpm_guided_wallclock_per_image"
    assert record["unit"] == "seconds" and record["device"] == "cpu"
    assert record["value"] > 0 and "mfu" not in record and "vs_baseline" not in record
    _, ucfg, ccfg, steps = bench.build(64, "ViT-B/32", "ddim2", 2, device="cpu")
    assert steps == 2
    assert record["flops_per_step"] == bench.guided_step_flops(ucfg, ccfg, 64, 1, 2, False)


def test_bench_and_time_components_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.build(64, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        time_components.measure_components(64, "cuda", 1)


def test_time_components_on_the_cpu(monkeypatch):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    ms = time_components.measure_components(64, "cpu", 1)
    assert set(ms) == {"fwd", "fwd_grad", "step"} and all(v > 0 for v in ms.values())


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_xlas_count_of_the_jax_step_is_near_the_analytic_one(models, fast):
    """The JAX bench's ``_guided_step_flops`` (XLA's cost analysis of the
    compiled step, on this CPU) against ``guided_step_flops`` at the toy
    point: within 5%. XLA also counts elementwise work (more) and drops
    what its optimizer proves unused, such as the UNet's variance channels
    under fast guidance (less)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "jax_bench", Path(__file__).resolve().parents[1] / "bench.py")
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    jucfg = models["jucfg"]
    jdiff = jgauss.make_diffusion(1000, "linear", "ddim25")
    jbuilder = jpipe.make_guidance_builder(
        models["jccfg"], np.random.RandomState(2).randn(1, 16).astype(np.float32),
        np.ones((1,), np.float32), jdiff, jpipe.GuidanceSettings(clip_compute_dtype="float32"))

    def jmodel(params, x_, t_model, rng, y):
        return junet.apply_unet(params["unet"], jucfg, x_, t_model, y)

    step = jsampler.make_guided_step(
        jdiff, jmodel, jbuilder(jsampler.StepMeta(t=0, guided=True, cutn=CUTN)),
        jsampler.SamplerConfig(use_ddim=True, randomize_class=False, fast_guidance=fast))
    xla = jbench._guided_step_flops(step, models["jparams"], jnp.zeros((1, SIZE, SIZE, 3)),
                                    jnp.zeros((1,), jnp.int32), False)
    ours = bench.guided_step_flops(tunet.UNetConfig(**UKW, num_classes=10), VIT, SIZE, 1, CUTN,
                                   fast)
    assert xla is not None and 0.95 < xla / ours < 1.05, (xla, ours)
