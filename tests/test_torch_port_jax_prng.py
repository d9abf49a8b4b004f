"""``cgd_tpu_torch/tools/jax_prng.py`` (``jax.random``'s Threefry-2x32
generator in numpy) against ``jax.random`` on the CPU, bit for bit: every
comparison is of ``uint32`` words or of f32 values through their ``uint32``
views (tolerance: none). Then the guided-quality proxy's cutout
coordinates, drawn through it, against the JAX package's
``sample_cutout_coords`` under the JAX tool's keys.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from cgd_tpu.guidance.cutouts import sample_cutout_coords  # noqa: E402
from cgd_tpu_torch.tools import guided_quality_proxy as tq  # noqa: E402
from cgd_tpu_torch.tools import jax_prng  # noqa: E402

SEEDS = [0, 1, 123, 999, 2**31 - 1, 2**32 - 1]
DATA = [0, 1, 2, 249, 999]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a.astype(np.uint32)


def test_threefry2x32_is_jaxs():
    rs = np.random.RandomState(0)
    k = rs.randint(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x0, x1 = (rs.randint(0, 2**32, 37, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    want = jprng.threefry2x32_p.bind(*(jax.numpy.asarray(v) for v in (k[0], k[1], x0, x1)))
    got = jax_prng.threefry2x32(k[0], k[1], x0, x1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_are_jaxs(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jax_prng.prng_key(seed), _bits(key))
    for d in DATA:
        np.testing.assert_array_equal(jax_prng.fold_in(jax_prng.prng_key(seed), d),
                                      _bits(jax.random.fold_in(key, d)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_is_jaxs(seed, num):
    for d in (0, 999):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        got = jax_prng.split(jax_prng.fold_in(jax_prng.prng_key(seed), d), num)
        assert got.shape == (num, 2) and got.dtype == np.uint32
        np.testing.assert_array_equal(got, _bits(jax.random.split(key, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((16,), 0.0, 1.0), ((7,), 0.0, 1.0), ((), 0.0, 1.0), ((3, 5), -15.0, 15.0),
    ((1001,), -0.1, 0.1), ((64, 2), -0.4 / 224, 0.4 / 224), ((8,), 2.0, 3.0)])
def test_uniform_is_jaxs(seed, shape, lo, hi):
    for d in (0, 7, 999):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        want = jax.random.uniform(key, shape, minval=lo, maxval=hi)
        got = jax_prng.uniform(jax_prng.fold_in(jax_prng.prng_key(seed), d), shape, lo, hi)
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert (got >= lo).all() and (got < hi).all()


def test_uniform_takes_an_int_shape():
    key = jax_prng.prng_key(5)
    np.testing.assert_array_equal(jax_prng.uniform(key, 9), jax_prng.uniform(key, (9,)))


@pytest.mark.parametrize("t", [0, 1, 7, 249])
@pytest.mark.parametrize("cutn", [4, 16])
def test_step_coords_are_the_jax_tools_draw(t, cutn):
    """``step_coords(t, cutn)`` is ``sample_cutout_coords`` under the JAX
    tool's key ``fold_in(PRNGKey(COORD_SEED), t)``, bit for bit."""
    key = jax.random.fold_in(jax.random.PRNGKey(tq.COORD_SEED), t)
    want = sample_cutout_coords(key, cutn, tq.SHAPE[2], tq.SHAPE[1], tq.CUT_SIZE)
    for got, ref in zip(tq.step_coords(t, cutn), want):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_the_eval_set_is_the_jax_tools_draw():
    """The held-out cutouts come from ``PRNGKey(EVAL_SEED)`` itself, with
    no fold_in, as in the JAX tool's ``compute_flag_table``."""
    want = sample_cutout_coords(jax.random.PRNGKey(tq.EVAL_SEED), tq.NUM_CUTOUTS, tq.SHAPE[2],
                                tq.SHAPE[1], tq.CUT_SIZE)
    got = tq.cutout_coords(jax_prng.prng_key(tq.EVAL_SEED), tq.NUM_CUTOUTS)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert not np.array_equal(got[2], tq.step_coords(0, tq.NUM_CUTOUTS, seed=tq.EVAL_SEED)[2])
