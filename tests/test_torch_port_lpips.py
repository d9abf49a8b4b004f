"""The LPIPS VGG init loss and the init-image loop in the port against
cgd_tpu, in f32 on the CPU, on identical weights (carried across by
cgd_tpu_torch.convert.from_jax):
- ``lpips_distance`` and its gradient with respect to x against cgd_tpu's
  and the torch replica's (tests/torch_ref_models.py ``TorchLPIPSVgg``):
  rtol 1e-4, atol 1e-4 x max |reference| (f32 sums in other orders);
- one guided step with the init loss (``init_scale`` 1000) and a three-step
  ``skip_timesteps`` + ``init_image`` loop, with the noise and the cutout
  coordinates drawn once with numpy and injected on both sides (the
  pattern of tests/test_torch_port_step.py). The guidance gradient is
  scaled by 1000, so x_next and pred_xstart are held to rtol 1e-4 and atol
  1e-4 x max |reference|, as there.
"""

import dataclasses

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
from cgd_tpu.models import vgg_lpips as jlpips  # noqa: E402
from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.diffusion import gaussian as tgauss  # noqa: E402
from cgd_tpu_torch.diffusion import sampler as tsampler  # noqa: E402
from cgd_tpu_torch.guidance import pipeline as tpipe  # noqa: E402
from cgd_tpu_torch.guidance.cutouts import CutoutSpec as TSpec  # noqa: E402
from cgd_tpu_torch.models import unet as tunet  # noqa: E402
from cgd_tpu_torch.models import vgg_lpips as tlpips  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402
from tests.torch_ref_models import TorchLPIPSVgg  # noqa: E402

torch.set_num_threads(2)

SIZE, CUTN, CLIP_RES = 32, 4, 16


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()), err_msg=what)


@pytest.fixture(scope="module")
def vgg():
    """cgd_tpu's random LPIPS weights (biases and heads perturbed away from
    their init), the port's module and the torch replica on them."""
    params = jax.tree.map(np.asarray, jlpips.init_vgg_lpips(jax.random.PRNGKey(3)))
    rs = np.random.RandomState(3)
    for c in params["convs"]:
        c["bias"] = (0.05 * rs.randn(*c["bias"].shape)).astype(np.float32)
    tm = TorchLPIPSVgg().eval()
    with torch.no_grad():
        for conv, p in zip(tm.convs, params["convs"]):
            conv.weight.copy_(torch.tensor(p["kernel"]).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.tensor(p["bias"]))
        for w, p in zip(tm.lins, params["lins"]):
            w.copy_(torch.tensor(p["kernel"][:, 0]))
    return params, load_from_jax(tlpips.VGGLPIPS(), params), tm


def _images(seed, b=2, size=SIZE):
    rs = np.random.RandomState(seed)
    return tuple((rs.rand(b, size, size, 3) * 2 - 1).astype(np.float32) for _ in range(2))


def test_lpips_distance_and_input_gradient_match_cgd_tpu_and_torch(vgg):
    params, model, tm = vgg
    x, y = _images(6)
    xt = torch.from_numpy(x).requires_grad_(True)
    d = tlpips.lpips_distance(model, xt, torch.from_numpy(y))
    (gx,) = torch.autograd.grad(d.sum(), xt)

    def jloss(x_):
        return jlpips.lpips_distance(params, x_, jnp.asarray(y)).sum()

    _close(d.detach(), jlpips.lpips_distance(params, jnp.asarray(x), jnp.asarray(y)), "distance")
    _close(gx, jax.grad(jloss)(jnp.asarray(x)), "d/dx vs cgd_tpu")

    xr = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    dr = tm(xr, torch.from_numpy(y).permute(0, 3, 1, 2))
    (gr,) = torch.autograd.grad(dr.sum(), xr)
    _close(d.detach(), dr.detach(), "distance vs torch")
    _close(gx, gr.permute(0, 2, 3, 1), "d/dx vs torch")


def test_lpips_of_an_image_with_itself_is_zero_in_f32(vgg):
    _, model, _ = vgg
    x, _ = _images(7, b=1)
    assert float(tlpips.lpips_distance(model, torch.from_numpy(x), torch.from_numpy(x))) == 0.0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert [tuple(c.kernel.shape) for c in model.convs][::6] == [(3, 3, 3, 64), (3, 3, 256, 256),
                                                               (3, 3, 512, 512)]


def _perturb(params, seed):
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [jnp.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32) for l in leaves])


@pytest.fixture(scope="module")
def models(vgg):
    ukw = dict(image_size=SIZE, model_channels=32, num_res_blocks=1, attention_ds=(2,),
               channel_mult=(1, 2), num_head_channels=16, num_classes=10)
    jucfg, tucfg = junet.UNetConfig(**ukw), tunet.UNetConfig(**ukw)
    uparams = _perturb(junet.init_unet(jax.random.PRNGKey(0), jucfg), 0)
    jccfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["ViT-B/32"], vision=jconfigs.VisionViTConfig(CLIP_RES, 8, 32, 1, 2),
        text=jconfigs.TextConfig(context_length=8, vocab_size=50, width=32, heads=2, layers=1),
        embed_dim=16)
    tccfg = tconfigs.CLIPConfig(jccfg.name, 16, tconfigs.VisionViTConfig(CLIP_RES, 8, 32, 1, 2),
                                tconfigs.TextConfig(8, 50, 32, 2, 1))
    cparams = _perturb(jclip.init_clip(jax.random.PRNGKey(1), jccfg), 1)
    lparams, lmodel, _ = vgg
    return dict(jucfg=jucfg, jccfg=jccfg, tccfg=tccfg,
                jparams={"unet": uparams, "clip": cparams, "lpips": lparams},
                unet=load_from_jax(tunet.UNet(tucfg), uparams),
                clip=load_from_jax(tclip.CLIP(tccfg), cparams), lpips=lmodel)


def _draws(n_steps, seed=0):
    rs = np.random.RandomState(seed)
    size = np.array([20.0, 32.0, 17.0, 25.0], np.float32)
    return dict(
        x=rs.randn(1, SIZE, SIZE, 3).astype(np.float32),
        init=(rs.rand(1, SIZE, SIZE, 3) * 2 - 1).astype(np.float32),
        noise=rs.randn(n_steps, 1, SIZE, SIZE, 3).astype(np.float32),
        coords=(np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32),
                np.floor(rs.rand(CUTN) * (SIZE - size + 1)).astype(np.float32), size),
        targets=rs.randn(2, 16).astype(np.float32),
        weights=np.array([0.75, 0.25], np.float32),
    )


def _pair(models, d, respacing):
    """JAX and port (diffusion, builder, sampler cfg, params, model_fn) with
    the init loss, on the same weights, targets, init image and cutouts."""
    jdiff = jgauss.make_diffusion(timestep_respacing=respacing)
    tdiff = tgauss.make_diffusion(timestep_respacing=respacing)
    settings = dict(clip_guidance_scale=1000.0, tv_scale=150.0, range_scale=50.0,
                    init_scale=1000.0, clip_compute_dtype="float32")
    jbuilder = jpipe.make_guidance_builder(
        models["jccfg"], d["targets"], d["weights"], jdiff, jpipe.GuidanceSettings(**settings),
        use_init_loss=True, cached_coords=JSpec(*d["coords"]))
    tbuilder = tpipe.make_guidance_builder(
        models["clip"], models["tccfg"], torch.from_numpy(d["targets"]),
        torch.from_numpy(d["weights"]), tpipe.GuidanceSettings(**settings),
        cached_coords=TSpec(*(torch.from_numpy(c) for c in d["coords"])),
        lpips=models["lpips"],
        init_image=torch.from_numpy(d["init"]))
    jparams = {**models["jparams"], "init_image": jnp.asarray(d["init"])}
    jucfg = models["jucfg"]

    def jmodel(params, x, t, r, y):
        return junet.apply_unet(params["unet"], jucfg, x, t, y)

    def tmodel(x, t, y):
        return models["unet"](x, t, y)

    return (jdiff, jbuilder, jparams, jmodel), (tdiff, tbuilder, tmodel)


def test_one_guided_step_with_the_init_loss_matches_jax(models):
    d = _draws(1)
    (jdiff, jb, jparams, jmodel), (tdiff, tb, tmodel) = _pair(models, d, "ddim25")
    jcfg, tcfg = jsampler.SamplerConfig(use_ddim=True), tsampler.SamplerConfig(use_ddim=True)
    meta = jsampler.StepMeta(t=17, guided=True, cutn=CUTN)
    jstep = jax.jit(jsampler.make_guided_step(jdiff, jmodel, jb(meta), jcfg, with_log=True))
    x_ref, pred_ref, _, jlog = jstep(jparams, jnp.asarray(d["x"]), 17, 20, jnp.asarray([3]),
                                     jax.random.PRNGKey(0),
                                     noise_override=jnp.asarray(d["noise"][0]))
    tstep = tsampler.make_guided_step(tdiff, tmodel, tb(tsampler.StepMeta(17, True, CUTN)), tcfg)
    x_next, pred, _, log = tstep(torch.from_numpy(d["x"]), 17, 20, torch.tensor([3]),
                                 torch.Generator().manual_seed(0),
                                 noise_override=torch.from_numpy(d["noise"][0]))
    assert float(log["Init VGG Loss"]) > 0
    np.testing.assert_allclose(float(log["Init VGG Loss"]), float(jlog["Init VGG Loss"]),
                               rtol=1e-4)
    _close(pred, pred_ref, "pred_xstart")
    _close(x_next, x_ref, "x_next")


@pytest.mark.parametrize("with_init", [True, False], ids=["init_image", "zeros"])
def test_skip_loop_from_the_init_image_matches_jax(models, with_init):
    """ddim5 with skip_timesteps 2: three guided steps from
    q_sample(init or zeros, t0, noise)."""
    d = _draws(3, seed=1)
    (jdiff, jb, jparams, jmodel), (tdiff, tb, tmodel) = _pair(models, d, "ddim5")
    shape = (1, SIZE, SIZE, 3)
    init_j = jnp.asarray(d["init"]) if with_init else None
    init_t = torch.from_numpy(d["init"]) if with_init else None
    jframes = list(jsampler.sample_loop(
        jdiff, jmodel, jb, jparams, shape, jax.random.PRNGKey(0),
        jsampler.SamplerConfig(use_ddim=True), skip_timesteps=2, init_image=init_j,
        num_cutouts=CUTN, save_frequency=1, y_init=jnp.asarray([4]),
        noise_override=d["noise"], init_noise=d["x"]))
    tframes = list(tsampler.sample_loop(
        tdiff, tmodel, tb, shape, torch.Generator().manual_seed(0),
        tsampler.SamplerConfig(use_ddim=True), skip_timesteps=2, init_image=init_t,
        num_cutouts=CUTN, save_frequency=1, y_init=torch.tensor([4]),
        noise_override=d["noise"], init_noise=d["x"]))
    assert [k for k, _, _ in tframes] == [k for k, _, _ in jframes] == [0, 1, 2]
    for (k, tp, tx), (_, jp, jx) in zip(tframes, jframes):
        _close(tp, jp, f"pred_xstart step {k}")
        _close(tx, jx, f"x step {k}")


@pytest.mark.parametrize("parity", [True, False])
def test_skip_loop_saves_the_final_frame_only_without_strict_parity(models, parity):
    """save_frequency 2 over three steps: frames at 0 and 2 under either
    parity with no skip; with skip 1 (two steps, the last at index 1) the
    reference quirk drops the final frame under strict parity."""
    d = _draws(3, seed=2)
    _, (tdiff, tb, tmodel) = _pair(models, d, "ddim3")
    frames = [k for k, _, _ in tsampler.sample_loop(
        tdiff, tmodel, tb, (1, SIZE, SIZE, 3), torch.Generator().manual_seed(0),
        tsampler.SamplerConfig(use_ddim=True), skip_timesteps=1,
        init_image=torch.from_numpy(d["init"]), num_cutouts=CUTN, save_frequency=2,
        y_init=torch.tensor([1]), noise_override=d["noise"], init_noise=d["x"],
        final_frame_parity=parity)]
    assert frames == ([0] if parity else [0, 1])
