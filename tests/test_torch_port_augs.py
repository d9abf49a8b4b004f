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
``use_augs`` against ``make_guided_step`` with the draws injected; and the
warp's own backward (``kernels/warp.py``, a fixed-order segment sum in
place of a gather's atomic scatter on a card): its forward bit-equal to the
four gathers it replaces, its gradient bit-equal to their autograd
gradient on the CPU (also at a draw whose clamped corners collect hundreds
of pairs a tap), its summation order a function of the draw alone, its
index the sort-and-search index it replaced with each segment classed
short or long. tests/test_torch_port_cuda.py holds the kernels to it on a
card.
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
from cgd_tpu_torch.kernels import warp as twarp  # noqa: E402
from cgd_tpu_torch.tools.warp_bench import long_draw  # noqa: E402
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


# ---- the warp's deterministic backward (kernels/warp.py) ------------------

def _warp_case(n, size, seed):
    """Cutouts, a probe and the warp's inputs (the flipped cutouts, the four
    taps' source pixels and weights) of one draw, as apply_augs builds
    them; seed "long": warp_bench.long_draw, whose clamped corners collect
    hundreds of pairs a tap."""
    rs = np.random.RandomState(7 if seed == "long" else seed)
    cuts = torch.from_numpy(rs.rand(n, size, size, 3).astype(np.float32))
    probe = torch.from_numpy(rs.randn(n, size, size, 3).astype(np.float32))
    d = (long_draw(n, size, None) if seed == "long"
         else tcutouts.draw_augs(torch.Generator().manual_seed(seed), n, size, size, 3))
    seen = {}
    real = twarp.bilinear_warp

    def spy(x, idx, weight):
        seen.update(x=x.detach().clone(), idx=idx, weight=weight)
        return real(x, idx, weight)

    twarp.bilinear_warp = spy
    try:
        tcutouts.apply_augs(cuts, d)
    finally:
        twarp.bilinear_warp = real
    return cuts, probe, d, seen


def gather_warp(x, idx, weight):
    """The warp as apply_augs sampled it before kernels/warp.py: four
    autograd gathers summed in map_coordinates' order, in one expression."""
    n, hh, ww, c = x.shape
    flat = x.reshape(n, hh * ww, c)

    def tap(t):
        i = idx[t].reshape(n, hh * ww, 1).expand(n, hh * ww, c)
        return flat.gather(1, i).reshape(n, hh, ww, c)

    return (weight[0][..., None] * tap(0) + weight[1][..., None] * tap(1)
            + weight[2][..., None] * tap(2) + weight[3][..., None] * tap(3))


WARP_CASES = [(4, 16, 0), (6, 24, 1), (3, 224, 3), (16, 64, 4), (16, 64, "long")]


@pytest.mark.parametrize("n,size,seed", WARP_CASES)
def test_the_warp_forward_is_the_gathers_bit_for_bit(n, size, seed):
    _, _, _, w = _warp_case(n, size, seed)
    assert torch.equal(twarp.bilinear_warp(w["x"], w["idx"], w["weight"]),
                       gather_warp(w["x"], w["idx"], w["weight"]))


@pytest.mark.parametrize("n,size,seed", WARP_CASES)
def test_the_warp_gradient_is_the_gathers(n, size, seed):
    """The fixed-order backward against autograd through the four gathers,
    on the CPU: bit-equal, since it sums in the gathers' own order there
    (each tap's scatter in output order, then the taps from the last)."""
    _, probe, _, w = _warp_case(n, size, seed)
    grads = []
    for fn in (twarp.bilinear_warp, gather_warp):
        x = w["x"].clone().requires_grad_(True)
        (fn(x, w["idx"], w["weight"]) * probe).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1]), float((grads[0] - grads[1]).abs().max())
    assert float(grads[1].abs().max()) > 0


def test_the_segment_order_depends_on_the_draw_only():
    """warp_index sorts by (cutout, source pixel, tap) and keeps each bin's
    pairs in output pixel order: the same for any weights and any
    cotangent; each bin's start is its first pair; the plain backward is
    that order's per-tap sums, ((S3 + S2) + S1) + S0, added one by one."""
    n, size = 3, 12
    _, _, _, w = _warp_case(n, size, 7)
    idx, nsrc = w["idx"], n * size * size
    a = twarp.warp_index(idx, w["weight"])
    other = torch.rand(w["weight"].shape, generator=torch.Generator().manual_seed(1))
    b = twarp.warp_index(idx, other)
    for name in ("pair", "offsets", "long", "n_long"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    starts = a.offsets.long()
    assert a.pair.numel() == twarp.TAPS * nsrc and int(starts[0]) == 0
    assert int(starts[-1]) == a.pair.numel() and bool((starts[1:] >= starts[:-1]).all())
    bins = torch.repeat_interleave(torch.arange(twarp.TAPS * nsrc), starts.diff())
    same = bins[1:] == bins[:-1]
    assert bool((a.pair[1:][same] > a.pair[:-1][same]).all())  # output order inside a bin
    # each pair's bin holds it: its tap's source pixel is the bin's
    cut = a.pair.long() // (size * size)
    tap_src = idx.reshape(twarp.TAPS, -1)[bins % twarp.TAPS, a.pair.long()]
    assert torch.equal(cut * size * size + tap_src, bins // twarp.TAPS)
    # the plain backward, one addition at a time in numpy
    g = torch.randn(nsrc, 3, generator=torch.Generator().manual_seed(2))
    sums = np.zeros((twarp.TAPS, nsrc, 3), np.float32)
    for bin_, pair, wt in zip(bins.tolist(), a.pair.tolist(), a.weight.numpy()):
        src, tap = divmod(bin_, twarp.TAPS)
        sums[tap, src] += wt * g[pair].numpy()
    want = ((sums[3] + sums[2]) + sums[1]) + sums[0]
    np.testing.assert_array_equal(twarp.warp_bwd_plain(g, a).numpy(), want)


def sort_and_search_index(idx, weight):
    """The index as it was built before the bins took the tap and their
    starts came from a histogram: a stable sort of the int64 keys cutout *
    h * w + source pixel, each segment's start searched for; pair holds tap
    * n * h * w + output pixel."""
    taps, n, hh, ww = idx.shape
    hw, nsrc = hh * ww, n * hh * ww
    keys = (torch.arange(n)[:, None] * hw + idx.reshape(taps, n, hw)).reshape(-1)
    key, perm = torch.sort(keys, stable=True)
    offsets = torch.searchsorted(key, torch.arange(nsrc + 1))
    return key, perm.int(), weight.reshape(-1)[perm].float(), offsets.int()


@pytest.mark.parametrize("n,size,seed", WARP_CASES)
def test_the_index_keeps_the_sort_and_search_segments_and_order(n, size, seed):
    """The histogram index gives the sort-and-search index's segments,
    their starts, their pairs' order and weights, and the same taps."""
    _, _, _, w = _warp_case(n, size, seed)
    nsrc = n * size * size
    new = twarp.warp_index(w["idx"], w["weight"])
    key, pair, weight, offsets = sort_and_search_index(w["idx"], w["weight"])
    assert torch.equal(new.offsets[::twarp.TAPS], offsets)
    assert torch.equal(new.pair, pair % nsrc) and torch.equal(new.weight, weight)
    bins = torch.repeat_interleave(torch.arange(twarp.TAPS * nsrc), new.offsets.diff())
    assert torch.equal(bins // twarp.TAPS, key) and torch.equal(bins % twarp.TAPS, pair // nsrc)


@pytest.mark.parametrize("n,size,seed", WARP_CASES)
def test_every_segment_is_short_or_long_and_the_long_list_ascends(n, size, seed):
    """A segment (a source pixel's four bins) longer than LONG_PAIRS is
    long, the others short; the index lists the long ones first, ascending,
    then the short ones, ascending: each pixel once. The long draw's
    clamped corners hold bins longer than one round of K-warp-b's
    long-segment path (128 pairs)."""
    _, _, _, w = _warp_case(n, size, seed)
    index = twarp.warp_index(w["idx"], w["weight"])
    starts = index.offsets.long()
    seg = starts[twarp.TAPS::twarp.TAPS] - starts[:-1:twarp.TAPS]
    n_long = int(index.n_long)
    longs, shorts = index.long[:n_long].long(), index.long[n_long:].long()
    assert n_long == int((seg > twarp.LONG_PAIRS).sum())
    assert bool((seg[longs] > twarp.LONG_PAIRS).all()) and bool((seg[shorts] <= twarp.LONG_PAIRS).all())
    assert bool((longs[1:] > longs[:-1]).all()) and bool((shorts[1:] > shorts[:-1]).all())
    assert torch.equal(torch.sort(index.long.long())[0], torch.arange(seg.numel()))
    if seed == "long":
        assert int(starts.diff().max()) > 128 and n_long > 100


def test_the_warp_backward_refuses_what_it_cannot_take():
    _, _, _, w = _warp_case(2, 8, 0)
    with pytest.raises(ValueError, match="taps"):
        twarp.warp_index(w["idx"][:3], w["weight"][:3])
    index = twarp.warp_index(w["idx"], w["weight"])
    with pytest.raises(ValueError, match="no kernel"):
        twarp._warp_bwd_kernel(torch.zeros(2 * 64, 3), index)
    with pytest.raises(ValueError, match="no kernel"):
        twarp._warp_index_kernel(w["idx"], w["weight"])
