"""The port's guided step and sampling loop against cgd_tpu's, in f32 on the
CPU, on a tiny class-conditional UNet and a tiny ViT CLIP with identical
weights (carried across by cgd_tpu_torch.convert.from_jax). Random draws are
made once with numpy and injected on both sides: the step noise through
``noise_override``, the starting noise through ``init_noise``, the cutout
coordinates through ``cached_coords``; ``randomize_class`` is off.

Tolerance: the gradient of the loss with respect to x is scaled by the
guidance scale (1000 here, the API default), so f32 rounding differences in
the UNet / CLIP backward are amplified by it. x_next and pred_xstart are held
to atol = 1e-4 * max|reference| + rtol 1e-4, a bound relative to the scale
of the values (the unguided arithmetic agrees to ~1e-6).

Also pins the port's copies of the schedules, the respacing and the step
plans to the originals.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.diffusion import gaussian as jgauss  # noqa: E402
from cgd_tpu.diffusion import respace as jrespace  # noqa: E402
from cgd_tpu.diffusion import sampler as jsampler  # noqa: E402
from cgd_tpu.diffusion import schedules as jsched  # noqa: E402
from cgd_tpu.guidance import pipeline as jpipe  # noqa: E402
from cgd_tpu.guidance.cutouts import CutoutSpec as JSpec  # noqa: E402
from cgd_tpu.models import unet as junet  # noqa: E402
from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.diffusion import gaussian as tgauss  # noqa: E402
from cgd_tpu_torch.diffusion import respace as trespace  # noqa: E402
from cgd_tpu_torch.diffusion import sampler as tsampler  # noqa: E402
from cgd_tpu_torch.diffusion import schedules as tsched  # noqa: E402
from cgd_tpu_torch.guidance import pipeline as tpipe  # noqa: E402
from cgd_tpu_torch.guidance.cutouts import CutoutSpec as TSpec  # noqa: E402
from cgd_tpu_torch.models import unet as tunet  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402

torch.set_num_threads(2)

SIZE, CUTN, CLIP_RES = 32, 4, 16


def _perturb(params, seed):
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [jnp.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32) for l in leaves])


@pytest.fixture(scope="module")
def models():
    ukw = dict(image_size=SIZE, model_channels=32, num_res_blocks=1, attention_ds=(2,),
               channel_mult=(1, 2), num_head_channels=16, num_classes=10)
    jucfg, tucfg = junet.UNetConfig(**ukw), tunet.UNetConfig(**ukw)
    uparams = _perturb(junet.init_unet(jax.random.PRNGKey(0), jucfg), 0)
    jccfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["ViT-B/32"],
        vision=jconfigs.VisionViTConfig(CLIP_RES, 8, 32, 1, 2),
        text=jconfigs.TextConfig(context_length=8, vocab_size=50, width=32, heads=2, layers=1),
        embed_dim=16,
    )
    tccfg = tconfigs.CLIPConfig(
        jccfg.name, jccfg.embed_dim,
        tconfigs.VisionViTConfig(*dataclasses.astuple(jccfg.vision)),
        tconfigs.TextConfig(*dataclasses.astuple(jccfg.text)))
    cparams = _perturb(jclip.init_clip(jax.random.PRNGKey(1), jccfg), 1)
    return dict(
        jucfg=jucfg, jccfg=jccfg, tccfg=tccfg,
        jparams={"unet": uparams, "clip": cparams},
        unet=load_from_jax(tunet.UNet(tucfg), uparams),
        clip=load_from_jax(tclip.CLIP(tccfg), cparams),
    )


def _draws(n_steps, seed=0):
    rs = np.random.RandomState(seed)
    size = np.array([20.0, 32.0, 17.0, 25.0], np.float32)
    coords = (np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32),
              np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32), size)
    return dict(
        x=rs.randn(1, SIZE, SIZE, 3).astype(np.float32),
        noise=rs.randn(n_steps, 1, SIZE, SIZE, 3).astype(np.float32),
        coords=coords,
        targets=rs.randn(2, 16).astype(np.float32),
        weights=np.array([0.75, 0.25], np.float32),
    )


def _pair(models, d, respacing, use_ddim, use_magnitude=False, rescale=False, steps=1000):
    """JAX and port (diffusion, builder, sampler cfg, model_fn) on the same
    weights, targets and cutout coordinates."""
    kw = dict(steps=steps, timestep_respacing=respacing, rescale_timesteps=rescale)
    jdiff = jgauss.make_diffusion(**kw)
    tdiff = tgauss.make_diffusion(**kw)
    settings = dict(clip_guidance_scale=1000.0, tv_scale=150.0, range_scale=50.0,
                    sat_scale=10.0, use_magnitude=use_magnitude, clip_compute_dtype="float32")
    jbuilder = jpipe.make_guidance_builder(
        models["jccfg"], d["targets"], d["weights"], jdiff, jpipe.GuidanceSettings(**settings),
        cached_coords=JSpec(*d["coords"]))
    tbuilder = tpipe.make_guidance_builder(
        models["clip"], models["tccfg"], torch.from_numpy(d["targets"]),
        torch.from_numpy(d["weights"]), tdiff, tpipe.GuidanceSettings(**settings),
        cached_coords=TSpec(*(torch.from_numpy(c) for c in d["coords"])))
    jucfg = models["jucfg"]

    def jmodel(params, x, t, r, y):
        return junet.apply_unet(params["unet"], jucfg, x, t, y)

    def tmodel(x, t, y):
        return models["unet"](x, t, y)

    return (jdiff, jbuilder, jsampler.SamplerConfig(use_ddim=use_ddim), jmodel,
            tdiff, tbuilder, tsampler.SamplerConfig(use_ddim=use_ddim), tmodel)


def _close(ours, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()), err_msg=what)


@pytest.mark.parametrize("use_ddim,use_magnitude", [(True, False), (False, True)])
def test_one_guided_step_matches_jax(models, use_ddim, use_magnitude):
    d = _draws(1)
    jdiff, jb, jcfg, jmodel, tdiff, tb, tcfg, tmodel = _pair(
        models, d, "ddim25" if use_ddim else "25", use_ddim, use_magnitude)
    meta = jsampler.StepMeta(t=17, guided=True, cutn=CUTN)
    jstep = jax.jit(jsampler.make_guided_step(jdiff, jmodel, jb(meta), jcfg))
    x_ref, pred_ref, _ = jstep(models["jparams"], jnp.asarray(d["x"]), 17, 20, jnp.asarray([3]),
                               jax.random.PRNGKey(0), noise_override=jnp.asarray(d["noise"][0]))
    tstep = tsampler.make_guided_step(tdiff, tmodel, tb(tsampler.StepMeta(17, True, CUTN)), tcfg)
    x_next, pred, y, log = tstep(torch.from_numpy(d["x"]), 17, 20, torch.tensor([3]),
                                 torch.Generator().manual_seed(0),
                                 noise_override=torch.from_numpy(d["noise"][0]))
    assert int(y) == 3 and "Total Loss" in log and ("Magnitude" in log) == use_magnitude
    _close(pred, pred_ref, "pred_xstart")
    _close(x_next, x_ref, "x_next")


@pytest.fixture(scope="module")
def models_512style(models):
    """The 512px model's traits at toy size: a fractional first channel
    multiplier (0.5, 1, 2), with the same CLIP."""
    ukw = dict(image_size=SIZE, model_channels=32, num_res_blocks=1, attention_ds=(2,),
               channel_mult=(0.5, 1, 2), num_head_channels=16, num_classes=10)
    jucfg, tucfg = junet.UNetConfig(**ukw), tunet.UNetConfig(**ukw)
    uparams = _perturb(junet.init_unet(jax.random.PRNGKey(2), jucfg), 2)
    return dict(models, jucfg=jucfg, jparams={**models["jparams"], "unet": uparams},
                unet=load_from_jax(tunet.UNet(tucfg), uparams))


def test_512style_guided_step_with_rescaled_timesteps_matches_jax(models_512style):
    """One guided DDIM step as the 512px configuration runs it:
    rescale_timesteps=True (the model sees t * 1000 / T; T = 500 here, so
    the rescale is not the identity it is at T = 1000) and the fractional
    channel_mult."""
    models = models_512style
    d = _draws(1, seed=2)
    jdiff, jb, jcfg, jmodel, tdiff, tb, tcfg, tmodel = _pair(
        models, d, "ddim25", True, rescale=True, steps=500)
    t = np.array([0, 17, 24])
    np.testing.assert_allclose(tdiff.model_time(torch.from_numpy(t)).numpy(),
                               np.asarray(jdiff.model_time(jnp.asarray(t))), rtol=1e-6)
    assert float(tdiff.model_time(torch.tensor([24]))) == pytest.approx(960.0)
    meta = jsampler.StepMeta(t=17, guided=True, cutn=CUTN)
    jstep = jax.jit(jsampler.make_guided_step(jdiff, jmodel, jb(meta), jcfg))
    x_ref, pred_ref, _ = jstep(models["jparams"], jnp.asarray(d["x"]), 17, 20, jnp.asarray([5]),
                               jax.random.PRNGKey(0), noise_override=jnp.asarray(d["noise"][0]))
    tstep = tsampler.make_guided_step(tdiff, tmodel, tb(tsampler.StepMeta(17, True, CUTN)), tcfg)
    x_next, pred, _, _ = tstep(torch.from_numpy(d["x"]), 17, 20, torch.tensor([5]),
                               torch.Generator().manual_seed(0),
                               noise_override=torch.from_numpy(d["noise"][0]))
    _close(pred, pred_ref, "pred_xstart")
    _close(x_next, x_ref, "x_next")


@pytest.mark.parametrize("use_ddim", [True, False])
def test_three_step_loop_matches_jax(models, use_ddim):
    d = _draws(3, seed=1)
    respacing = "ddim3" if use_ddim else "3"
    jdiff, jb, jcfg, jmodel, tdiff, tb, tcfg, tmodel = _pair(models, d, respacing, use_ddim)
    shape = (1, SIZE, SIZE, 3)
    jframes = list(jsampler.sample_loop(
        jdiff, jmodel, jb, models["jparams"], shape, jax.random.PRNGKey(0), jcfg,
        num_cutouts=CUTN, save_frequency=1, y_init=jnp.asarray([4]),
        noise_override=d["noise"], init_noise=d["x"]))
    tframes = list(tsampler.sample_loop(
        tdiff, tmodel, tb, shape, torch.Generator().manual_seed(0), tcfg,
        num_cutouts=CUTN, save_frequency=1, y_init=torch.tensor([4]),
        noise_override=d["noise"], init_noise=d["x"]))
    assert [k for k, _, _ in tframes] == [k for k, _, _ in jframes] == [0, 1, 2]
    for (k, tp, tx), (_, jp, jx) in zip(tframes, jframes):
        _close(tp, jp, f"pred_xstart step {k}")
        _close(tx, jx, f"x step {k}")


def test_unguided_diffusion_arithmetic_matches_jax():
    """p_mean_variance and both updates on a given model output."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    out = rs.randn(2, 8, 8, 6).astype(np.float32)
    noise = rs.randn(2, 8, 8, 3).astype(np.float32)
    grad = rs.randn(2, 8, 8, 3).astype(np.float32)
    t = np.array([0, 7])
    jd, td = jgauss.make_diffusion(timestep_respacing="10"), tgauss.make_diffusion(timestep_respacing="10")
    jo = jd.p_mean_variance(jnp.asarray(out), jnp.asarray(x), jnp.asarray(t))
    to = td.p_mean_variance(torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(t))
    for name in jgauss.PMeanVariance._fields:
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    args_j = (jo, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise), jnp.asarray(grad))
    args_t = (to, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise),
              torch.from_numpy(grad))
    np.testing.assert_allclose(td.ddim_sample_step(*args_t, eta=0.5).numpy(),
                               np.asarray(jd.ddim_sample_step(*args_j, eta=0.5)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.p_sample_step(*args_t).numpy(),
                               np.asarray(jd.p_sample_step(*args_j)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(td.model_time(torch.from_numpy(t)).numpy(),
                                  np.asarray(jd.model_time(jnp.asarray(t))))


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("steps", [1000, 250])
def test_schedule_copy_matches_original(schedule, steps):
    jb, tb = jsched.get_named_beta_schedule(schedule, steps), tsched.get_named_beta_schedule(schedule, steps)
    np.testing.assert_array_equal(tb, jb)
    jc, tc = jsched.ScheduleCoefficients.from_betas(jb), tsched.ScheduleCoefficients.from_betas(tb)
    for f in dataclasses.fields(jc):
        np.testing.assert_array_equal(getattr(tc, f.name), getattr(jc, f.name), err_msg=f.name)


@pytest.mark.parametrize("spec", ["ddim25", "ddim250", "25", "250", "10,15,20", "1000"])
def test_respacing_copy_matches_original(spec):
    assert trespace.space_timesteps(1000, spec) == jrespace.space_timesteps(1000, spec)
    jd, td = jgauss.make_diffusion(timestep_respacing=spec), tgauss.make_diffusion(timestep_respacing=spec)
    np.testing.assert_array_equal(td.timestep_map, jd.timestep_map)
    np.testing.assert_array_equal(td.coeffs.betas, jd.coeffs.betas)


@pytest.mark.parametrize("skip,reduce_clip,progressive", [
    (0, False, False), (5, True, False), (0, False, True), (20, True, True)])
@pytest.mark.parametrize("save_frequency", [1, 7, 25])
def test_step_and_segment_plan_copies_match_original(skip, reduce_clip, progressive, save_frequency):
    jplan = jsampler.build_step_plan(100, skip, reduce_clip, progressive, 16)
    tplan = tsampler.build_step_plan(100, skip, reduce_clip, progressive, 16)
    assert [tuple(m) for m in tplan] == [tuple(m) for m in jplan]
    for parity in (True, False):
        jseg, jsave = jsampler.segment_plan(jplan, save_frequency, parity, skip)
        tseg, tsave = tsampler.segment_plan(tplan, save_frequency, parity, skip)
        assert tsave == jsave
        assert [(k, [tuple(m) for m in s]) for k, s in tseg] == \
               [(k, [tuple(m) for m in s]) for k, s in jseg]
