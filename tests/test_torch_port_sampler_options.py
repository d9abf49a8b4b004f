"""The sampler's options in the port against cgd_tpu, in f32 on the CPU:
DPM-Solver++(2M) (``dpm_solver2m_step`` and the loop's multistep state),
fast guidance (the guidance gradient through the blend only, no UNet
backward), and ``reduce_clip`` / ``progressive_cutout`` reaching the loop.

The models, draws and tolerances are tests/test_torch_port_step.py's: a tiny
class-conditional UNet and ViT CLIP on identical weights, the starting
noise, the step noise and the cutout coordinates drawn once with numpy and
injected on both sides, x_next / pred_xstart held to atol = 1e-4 *
max|reference| + rtol 1e-4 (the guidance scale of 1000 amplifies f32
rounding in the backward). ``dpm_solver2m_step`` on given inputs is held to
rtol 1e-5 / atol 1e-5, as the other updates are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.diffusion import gaussian as jgauss  # noqa: E402
from cgd_tpu.diffusion import sampler as jsampler  # noqa: E402
from cgd_tpu_torch.diffusion import gaussian as tgauss  # noqa: E402
from cgd_tpu_torch.diffusion import sampler as tsampler  # noqa: E402
from cgd_tpu_torch.kernels import attention as kattn  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402
from tests.test_torch_port_step import CUTN, SIZE, _close, _draws, _pair, models  # noqa: E402,F401

torch.set_num_threads(2)


def _clamp_engaged(diff, t, t_prev) -> bool:
    """Whether the extrapolation coefficient 1 / (2r) exceeds 0.5 at (t,
    t_prev), i.e. the previous log-SNR gap is the smaller."""
    a = np.asarray(diff.coeffs.alphas_cumprod, np.float64)
    ap = np.asarray(diff.coeffs.alphas_cumprod_prev, np.float64)

    def lam(x):
        return 0.5 * (np.log(x) - np.log(max(1.0 - x, 1e-20)))

    return (lam(a[t]) - lam(a[t_prev])) < (lam(ap[t]) - lam(a[t]))


@pytest.mark.parametrize("t,t_prev,first,guided", [
    (7, 7, True, False), (7, 7, True, True),   # first order on the first step
    (6, 7, False, False), (6, 7, False, True),  # second order
    (2, 3, False, True), (1, 2, False, False),  # second order, the 0.5 clamp engaged
    (0, 1, False, True),                        # the final step: first order
])
def test_dpm_solver2m_step_matches_jax(t, t_prev, first, guided):
    rs = np.random.RandomState(t + 10 * guided)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    out = rs.randn(2, 8, 8, 6).astype(np.float32)
    x0p = rs.randn(2, 8, 8, 3).astype(np.float32)
    grad = rs.randn(2, 8, 8, 3).astype(np.float32) if guided else None
    jd, td = (g.make_diffusion(timestep_respacing="ddim8") for g in (jgauss, tgauss))
    if (t, t_prev) in ((2, 3), (1, 2)):
        assert _clamp_engaged(td, t, t_prev)
    tb, tpb = np.array([t, t]), np.array([t_prev, t_prev])
    jo = jd.p_mean_variance(jnp.asarray(out), jnp.asarray(x), jnp.asarray(tb))
    to = td.p_mean_variance(torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(tb))
    jx, jx0 = jd.dpm_solver2m_step(jo, jnp.asarray(x), jnp.asarray(tb), jnp.asarray(tpb),
                                   jnp.asarray(first), jnp.asarray(x0p),
                                   None if grad is None else jnp.asarray(grad))
    tx, tx0 = td.dpm_solver2m_step(to, torch.from_numpy(x), torch.from_numpy(tb),
                                   torch.from_numpy(tpb), first, torch.from_numpy(x0p),
                                   None if grad is None else torch.from_numpy(grad))
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    if first or t == 0:  # first order is a DDIM eta = 0 step
        ddim = td.ddim_sample_step(to, torch.from_numpy(x), torch.from_numpy(tb),
                                   torch.zeros_like(torch.from_numpy(x)),
                                   None if grad is None else torch.from_numpy(grad))
        np.testing.assert_allclose(tx.numpy(), ddim.numpy(), rtol=1e-5, atol=1e-5)


def _jax_step(models, jdiff, jb, jcfg, jmodel, d, guided=True, **kw):
    meta = jsampler.StepMeta(t=17, guided=guided, cutn=CUTN)
    jstep = jax.jit(jsampler.make_guided_step(jdiff, jmodel, jb(meta) if guided else None, jcfg))
    return jstep(models["jparams"], jnp.asarray(d["x"]), 17, 20, jnp.asarray([3]),
                 jax.random.PRNGKey(0), noise_override=jnp.asarray(d["noise"][0]), **kw)


def _torch_step(tdiff, tb, tcfg, tmodel, d, guided=True, **kw):
    tstep = tsampler.make_guided_step(
        tdiff, tmodel, tb(tsampler.StepMeta(17, True, CUTN)) if guided else None, tcfg)
    return tstep(torch.from_numpy(d["x"]), 17, 20, torch.tensor([3]),
                 torch.Generator().manual_seed(0),
                 noise_override=torch.from_numpy(d["noise"][0]), **kw)


def test_one_fast_guidance_step_matches_jax(models, monkeypatch):
    """fast_guidance: the same x_next as the JAX step whose guidance sees a
    detached ``out``; the UNet forward runs with autograd off, and neither
    K-dx's wrapper nor the attention's backward is called (on the CPU the
    attention's backward is its plain version; on a card neither kernel
    launches)."""
    d = _draws(1, seed=6)
    jdiff, jb, jcfg, jmodel, tdiff, tb, tcfg, tmodel = _pair(
        models, d, "ddim25", True, sampler_kw={"fast_guidance": True})
    x_ref, pred_ref, _ = _jax_step(models, jdiff, jb, jcfg, jmodel, d)
    grad_on, backward = [], []

    def model(x, t, y):
        grad_on.append(torch.is_grad_enabled())
        return tmodel(x, t, y)

    for mod, name in ((k3, "conv3x3_dx"), (kattn, "attention_bwd_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: backward.append(_n) or _r(*a))
    x_next, pred, _, log = _torch_step(tdiff, tb, tcfg, model, d)
    assert grad_on == [False] and backward == [] and "Total Loss" in log
    _close(pred, pred_ref, "pred_xstart")
    _close(x_next, x_ref, "x_next")
    # the full guided step differs, and runs the UNet's backward
    _, _, _, tmodel_full = _pair(models, d, "ddim25", True)[4:]
    x_full = _torch_step(tdiff, tb, tsampler.SamplerConfig(use_ddim=True), tmodel_full, d)[0]
    assert "conv3x3_dx" in backward and "attention_bwd_plain" in backward
    assert float((x_full - x_next).abs().max()) > 1e-3


@pytest.mark.parametrize("order,guided", [(1, True), (2, True), (2, False)])
def test_one_dpm_solver_step_matches_jax(models, order, guided):
    """dpm_solver: the step's x_next and guided x0 against the JAX step's,
    first order (the run's first step) and second order from a given
    previous x0, guided and unguided."""
    d = _draws(1, seed=7 + order)
    jdiff, jb, jcfg, jmodel, tdiff, tb, tcfg, tmodel = _pair(
        models, d, "ddim25", True, sampler_kw={"dpm_solver": True})
    x0p = np.random.RandomState(order).randn(*d["x"].shape).astype(np.float32)
    first = order == 1
    x_ref, pred_ref, _, x0_ref = _jax_step(models, jdiff, jb, jcfg, jmodel, d, guided,
                                           dpm_state=(jnp.asarray(x0p), 18, first))
    x_next, pred, _, _, x0g = _torch_step(tdiff, tb, tcfg, tmodel, d, guided,
                                          dpm_state=(torch.from_numpy(x0p), 18, first))
    _close(pred, pred_ref, "pred_xstart")
    _close(x0g, x0_ref, "x0_guided")
    _close(x_next, x_ref, "x_next")


def _draws8(n_steps, seed):
    """_draws with eight cached cutout coordinates: progressive_cutout asks
    for max(8, cutn // 2) cutouts in its middle phase (the API sizes its
    cache so)."""
    d = _draws(n_steps, seed)
    rs = np.random.RandomState(seed + 100)
    size = np.floor(rs.rand(8) * (SIZE - 16 + 1) + 16).astype(np.float32)
    d["coords"] = (np.floor(rs.rand(8) * (SIZE - size + 1)).astype(np.float32),
                   np.floor(rs.rand(8) * (SIZE - size + 1)).astype(np.float32), size)
    return d


@pytest.mark.parametrize("dpm", [False, True], ids=["ddim", "dpm"])
def test_six_step_loop_with_reduce_clip_and_progressive_cutout_matches_jax(models, dpm):
    """sample_loop over ddim6 with reduce_clip and progressive_cutout: the
    plan guides steps 0, 1, 4, 5 (cutouts 4, 8, 4, 4) and runs 2, 3
    unguided; with dpm_solver the loop carries the guided x0 across those
    phases. Frames at every step against cgd_tpu's sample_loop."""
    d = _draws8(6, seed=11)
    jdiff, jb, jcfg, jmodel, tdiff, tb, tcfg, tmodel = _pair(
        models, d, "ddim6", True, sampler_kw={"dpm_solver": dpm})
    plan = tsampler.build_step_plan(6, 0, True, True, CUTN)
    assert [(m.guided, m.cutn) for m in plan] == [(True, 4), (True, 8), (False, 8),
                                                 (False, 8), (True, 4), (True, 4)]
    built = []
    real_tb = tb

    def tb_counted(meta):
        built.append(meta.cutn)
        return real_tb(meta)

    shape = (1, SIZE, SIZE, 3)
    common = dict(reduce_clip=True, progressive_cutout=True, num_cutouts=CUTN, save_frequency=1,
                  noise_override=d["noise"], init_noise=d["x"])
    jframes = list(jsampler.sample_loop(
        jdiff, jmodel, jb, models["jparams"], shape, jax.random.PRNGKey(0), jcfg,
        y_init=jnp.asarray([4]), **common))
    tframes = list(tsampler.sample_loop(
        tdiff, tmodel, tb_counted, shape, torch.Generator().manual_seed(0), tcfg,
        y_init=torch.tensor([4]), **common))
    assert built == [4, 8]  # one guidance per distinct (guided, cutn)
    assert [k for k, _, _ in tframes] == [k for k, _, _ in jframes] == list(range(6))
    for (k, tp, tx), (_, jp, jx) in zip(tframes, jframes):
        _close(tp, jp, f"pred_xstart step {k}")
        _close(tx, jx, f"x step {k}")


def test_recorded_noise_replays_and_leaves_the_other_draws_alone(models):
    """noise_override / init_noise replace the noise after it is drawn: a
    run replaying the noise another run drew (class labels and cutout
    coordinates drawn fresh from the generator) gives the same frames."""
    d = _draws(3, seed=12)
    _, _, _, _, tdiff, _, _, tmodel = _pair(models, d, "ddim3", True)
    from cgd_tpu_torch.guidance import pipeline as tpipe

    builder = tpipe.make_guidance_builder(
        models["clip"], models["tccfg"], torch.from_numpy(d["targets"]),
        torch.from_numpy(d["weights"]),
        tpipe.GuidanceSettings(clip_compute_dtype="float32", use_augs=True))
    cfg = tsampler.SamplerConfig(use_ddim=True, eta=0.5, randomize_class=True, num_classes=10)
    shape = (1, SIZE, SIZE, 3)
    drawn = []
    real_randn = torch.randn

    def recording(*a, **kw):
        out = real_randn(*a, **kw)
        if tuple(out.shape) == shape:
            drawn.append(out.clone())
        return out

    def run(**kw):
        return [(k, p.clone(), x.clone()) for k, p, x in tsampler.sample_loop(
            tdiff, tmodel, builder, shape, torch.Generator().manual_seed(5), cfg,
            num_cutouts=CUTN, y_init=torch.tensor([1]), **kw)]

    torch.randn = recording
    try:
        first = run()
    finally:
        torch.randn = real_randn
    assert len(drawn) == 4  # the start and three steps
    again = run(init_noise=drawn[0].numpy(), noise_override=torch.stack(drawn[1:]).numpy())
    other = run(init_noise=np.zeros(shape, np.float32))
    for (k, p, x), (_, p2, x2) in zip(first, again):
        assert torch.equal(p, p2) and torch.equal(x, x2), k
    assert not torch.equal(first[-1][2], other[-1][2])
