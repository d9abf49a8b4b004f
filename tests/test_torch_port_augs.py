"""The cutout augmentations (``use_augs``) of the port against
cgd_tpu.guidance.cutouts.augment_cutouts, in f32 on the CPU.

A ``jax.random`` stream cannot be reproduced in torch, so the draws are made
here by the JAX calls ``augment_cutouts`` makes (the same
``jax.random.split(rng, 8)`` and the same ``bernoulli`` / ``uniform`` /
``normal`` calls), carried across as numpy arrays into the port's
``AugDraws``, and fed to ``apply_augs``; the result, and its gradient with
respect to the cutouts, are held to ``augment_cutouts(rng, cuts)`` and its
gradient. Tolerance: rtol 1e-5, atol 1e-5 * max|reference| (f32: the warp's
coordinates are computed in the same order on both sides). The reference
runs op by op, not under ``jax.jit``: XLA's fusion of the coordinate
arithmetic moves JAX's own 224^2 values past that bound (f32 rounding of
coordinates near 100 pixels from the centre, as far from an f64 evaluation
as the op-by-op values are).

Also: the draw's shapes, ranges and order, and one guided step with
``use_augs`` against ``make_guided_step`` with the draws injected.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.diffusion import sampler as jsampler  # noqa: E402
from cgd_tpu.guidance import cutouts as jcutouts  # noqa: E402
from cgd_tpu_torch.diffusion import sampler as tsampler  # noqa: E402
from cgd_tpu_torch.guidance import cutouts as tcutouts  # noqa: E402
from tests.test_torch_port_step import CUTN, _close, _draws, _pair, models  # noqa: E402,F401

torch.set_num_threads(2)


def jax_draws(rng, n, hh, ww, c) -> tcutouts.AugDraws:
    """The draws augment_cutouts(rng, cutouts[n, hh, ww, c]) makes, as the
    port's AugDraws."""
    keys = jax.random.split(rng, 8)
    lim = 0.4 / max(hh, ww)
    draws = [
        jax.random.bernoulli(keys[0], 0.5, (n, 1, 1, 1)).reshape(n),
        jax.random.uniform(keys[1], (n,), minval=-15.0, maxval=15.0),
        jax.random.uniform(keys[2], (n,), minval=-0.1, maxval=0.1),
        jax.random.uniform(keys[3], (n,), minval=-0.1, maxval=0.1),
        jax.random.bernoulli(keys[4], 0.7, (n,)),
        jax.random.uniform(keys[5], (n, 2), minval=-lim, maxval=lim),
        jax.random.bernoulli(keys[6], 0.15, (n, 1, 1, 1)).reshape(n),
        jax.random.normal(keys[7], (n, hh, ww, c)),
    ]
    return tcutouts.AugDraws(*(torch.from_numpy(np.array(d)) for d in draws))


@pytest.mark.parametrize("n,size,seed", [(4, 16, 0), (6, 24, 1), (8, 12, 2), (3, 224, 3)])
def test_apply_augs_values_and_gradient_match_augment_cutouts(n, size, seed):
    rs = np.random.RandomState(seed)
    cuts = rs.rand(n, size, size, 3).astype(np.float32)
    probe = rs.randn(n, size, size, 3).astype(np.float32)
    rng = jax.random.PRNGKey(seed)

    def jloss(c):
        out = jcutouts.augment_cutouts(rng, c)
        return jnp.sum(out * probe), out

    (_, ref), gref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(cuts))
    draws = jax_draws(rng, n, size, size, 3)
    ct = torch.from_numpy(cuts).requires_grad_(True)
    out = tcutouts.apply_augs(ct, draws)
    (out * torch.from_numpy(probe)).sum().backward()
    ref, gref = np.asarray(ref), np.asarray(gref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(ct.grad.numpy(), gref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(gref).max()))


def test_the_warp_reaches_the_edges_and_clamps_there():
    """A +-10% translation moves source coordinates past the border on every
    draw: those pixels take the border's value (map_coordinates' "nearest"),
    as a pure shift by 3 of a 16-wide ramp shows."""
    n, size = 2, 16
    ramp = np.broadcast_to(np.arange(size, dtype=np.float32)[None, None, :, None],
                           (n, size, size, 3)).copy()
    zeros = torch.zeros(n)
    draws = tcutouts.AugDraws(
        flip=zeros.bool(), angle=zeros, tx=torch.tensor([0.1875, -0.1875]), ty=zeros,
        persp_on=zeros.bool(), persp=torch.zeros(n, 2), gray=zeros.bool(),
        noise=torch.zeros(n, size, size, 3))
    out = tcutouts.apply_augs(torch.from_numpy(ramp), draws).numpy()
    np.testing.assert_allclose(out[0, 0, :, 0], np.clip(np.arange(size) - 3.0, 0, size - 1),
                               atol=1e-5)
    np.testing.assert_allclose(out[1, 0, :, 0], np.clip(np.arange(size) + 3.0, 0, size - 1),
                               atol=1e-5)


def test_draw_augs_shapes_ranges_and_order():
    """Eight draws from the generator in AugDraws' order (the noise last),
    on the generator's device, within their ranges."""
    n, hh, ww, c = 64, 20, 30, 3
    d = tcutouts.draw_augs(torch.Generator().manual_seed(0), n, hh, ww, c)
    assert d.flip.dtype == d.persp_on.dtype == d.gray.dtype == torch.bool
    assert d.flip.shape == d.angle.shape == d.tx.shape == d.gray.shape == (n,)
    assert d.persp.shape == (n, 2) and d.noise.shape == (n, hh, ww, c)
    assert float(d.angle.abs().max()) <= 15.0 and float(d.angle.abs().max()) > 10.0
    assert float(d.tx.abs().max()) <= 0.1 and float(d.ty.abs().max()) <= 0.1
    assert float(d.persp.abs().max()) <= 0.4 / ww
    assert 0 < int(d.gray.sum()) < int(d.persp_on.sum()) < n
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(torch.rand(n, generator=gen) < 0.5, d.flip)
    # the draw consumed exactly its eight draws, the noise last
    gen = torch.Generator().manual_seed(0)
    tcutouts.draw_augs(gen, n, hh, ww, c)
    after = torch.Generator().manual_seed(0)
    for shape in [(n,), (n,), (n,), (n,), (n,), (n, 2), (n,)]:
        torch.rand(*shape, generator=after)
    assert torch.equal(torch.randn(n, hh, ww, c, generator=after), d.noise)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=after))


def test_one_guided_step_with_augs_matches_jax(models, monkeypatch):
    """make_guided_step with use_augs: the JAX step's augmentation key
    (rng -> r_guide -> r_augs) reproduced here, its draws injected into the
    port's step in place of draw_augs; pred_xstart and x_next at the step
    file's tolerance."""
    d = _draws(1, seed=5)
    jdiff, jb, jcfg, jmodel, tdiff, tb, tcfg, tmodel = _pair(
        models, d, "ddim25", True, use_augs=True)
    rng = jax.random.PRNGKey(3)
    meta = jsampler.StepMeta(t=17, guided=True, cutn=CUTN)
    jstep = jax.jit(jsampler.make_guided_step(jdiff, jmodel, jb(meta), jcfg))
    x_ref, pred_ref, _ = jstep(models["jparams"], jnp.asarray(d["x"]), 17, 20, jnp.asarray([3]),
                               rng, noise_override=jnp.asarray(d["noise"][0]))
    r_guide = jax.random.split(rng, 4)[3]
    r_augs = jax.random.split(r_guide)[1]
    res = models["jccfg"].vision.input_resolution
    injected = jax_draws(r_augs, CUTN, res, res, 3)
    seen = []

    def draw(gen, n, hh, ww, c):
        seen.append((n, hh, ww, c))
        return injected

    monkeypatch.setattr(tcutouts, "draw_augs", draw)
    tstep = tsampler.make_guided_step(tdiff, tmodel, tb(tsampler.StepMeta(17, True, CUTN)), tcfg)
    x_next, pred, _, _ = tstep(torch.from_numpy(d["x"]), 17, 20, torch.tensor([3]),
                               torch.Generator().manual_seed(0),
                               noise_override=torch.from_numpy(d["noise"][0]))
    assert seen == [(CUTN, res, res, 3)]
    _close(pred, pred_ref, "pred_xstart")
    _close(x_next, x_ref, "x_next")
