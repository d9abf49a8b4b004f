"""``cgd_tpu_torch/tools/guided_quality_proxy.py`` against the JAX package's
``tools/guided_quality_proxy.py`` on the CPU, in f32.

- the toy tower on seeded inputs (whole 16x16 images, 8x8 cutouts, an odd
  side): within 1e-6, which pins XLA's "SAME" padding at stride 2 (nothing
  before, one after on an even side);
- the solver arms ddim10, dpm10 and fast10 through the port's
  ``sample_loop`` against the JAX tool's ``_run_arm``, and one flag arm
  (all three flags: reduce-clip's skip and gating, progressive cutout
  counts, cached coordinates) with the port's cutout coordinates injected
  on both sides: relative L2 error of the final samples <= 1e-4 (the
  guided step's f32 rounding, amplified by CGS over ten steps);
- the port's whole flag table against the JAX tool's
  ``compute_flag_table``: within relative 1e-4 in every entry (its
  coordinates are the JAX tool's, tests/test_torch_port_jax_prng.py).

``TestThePortsTablesKeepTheClaims`` holds the port's own tables to the
claims of tests/test_guided_quality.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cgd_tpu_torch.tools import guided_quality_proxy as tq  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def jq():
    spec = importlib.util.spec_from_file_location(
        "jax_guided_quality_proxy", ROOT / "tools" / "guided_quality_proxy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (32, 8, 8, 3), (2, 15, 15, 3)])
def test_the_tower_matches_jax(jq, shape):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    jembed, jtarget = jq._build_tower()
    tembed, ttarget = tq.build_tower("cpu")
    want = np.asarray(jembed(jnp.asarray(x)))
    got = tembed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ttarget.numpy(), jtarget)
    np.testing.assert_allclose(tq.spherical(torch.from_numpy(got), ttarget).numpy(),
                               np.asarray(jq._spherical(jnp.asarray(want), jtarget)),
                               rtol=1e-6, atol=0)  # values up to ~5: a few f32 ulps


@pytest.mark.parametrize("mode", ["ddim", "dpm", "fast"])
def test_solver_arms_match_jax(jq, mode):
    xs = tq.x_start()
    jembed, jtarget = jq._build_tower()
    want = jq._run_arm(10, mode, jq._build_model_fn(),
                       lambda d, cached: jq._make_solver_builder(d, jembed, jtarget), xs)
    model_fn, builder_for, _ = tq.solver_parts("cpu")
    got = tq.run_arm(10, mode, model_fn, builder_for, xs, device="cpu")
    assert _rel(got, want) <= REL_TOL, (mode, _rel(got, want))
    assert _rel(got, xs) > 0.1  # the arm moved the sample


def test_a_flag_arm_matches_jax_with_the_same_coordinates(jq):
    from cgd_tpu.diffusion.sampler import GuidanceFns
    from cgd_tpu.guidance.cutouts import CutoutSpec, make_cutouts

    xs = tq.x_start()
    jembed, jtarget = jq._build_tower()

    def jbuilder_for(diffusion, cached):
        sqrt_om = np.asarray(diffusion.sqrt_one_minus_alphas_cumprod)
        steps = diffusion.num_timesteps

        def builder(meta):
            # the JAX tool's _make_flag_builder, its fold_in(PRNGKey(123),
            # ref_t) draws replaced by the port's numpy coordinates, indexed
            # by the traced ref_t
            table = jnp.asarray(np.stack([
                np.stack(tq.step_coords(0 if cached else r, meta.cutn)) for r in range(steps)]))

            def loss_fn(params, rng, x, out, ref_t):
                fac = jnp.asarray(sqrt_om)[ref_t]
                x_in = out.pred_xstart * fac + x * (1.0 - fac)
                c = table[ref_t]
                cuts = make_cutouts(x_in, CutoutSpec(c[0], c[1], c[2]), tq.CUT_SIZE)
                return tq.CGS * jq._spherical(jembed(cuts), jtarget).mean() * tq.SHAPE[0]

            return GuidanceFns(loss_fn, lambda g: g)

        return builder

    flags = dict(reduce_clip=True, progressive_cutout=True, cached_cutouts=True)
    want = jq._run_arm(10, "ddim", jq._build_model_fn(), jbuilder_for, xs,
                       num_cutouts=tq.NUM_CUTOUTS, **flags)
    tembed, ttarget = tq.build_tower("cpu")
    got = tq.run_arm(10, "ddim", tq.build_model_fn("cpu"),
                     lambda cached: tq.make_flag_builder(tembed, ttarget, cached), xs,
                     device="cpu", num_cutouts=tq.NUM_CUTOUTS, **flags)
    assert _rel(got, want) <= REL_TOL, _rel(got, want)


def test_step_coords_follow_the_cutout_rule():
    ox, oy, size = tq.step_coords(7, 16)
    assert size.dtype == np.float32 and size.shape == (16,)
    assert (size >= tq.CUT_SIZE).all() and (size <= tq.SHAPE[1]).all()
    assert (ox >= 0).all() and (ox + size <= tq.SHAPE[1]).all() and (oy + size <= tq.SHAPE[1]).all()
    assert all(np.array_equal(a, b) for a, b in zip(tq.step_coords(7, 16), (ox, oy, size)))
    assert not np.array_equal(tq.step_coords(8, 16)[2], size)


@pytest.fixture(scope="module")
def table():
    return tq.compute_table("cpu")


@pytest.fixture(scope="module")
def flag_table():
    return tq.compute_flag_table("cpu")


class TestThePortsTablesKeepTheClaims:
    """tests/test_guided_quality.py's claims, on the port's tables (the flag
    table on the JAX tool's coordinates)."""

    def test_dpm50_matches_ddim250_quality(self, table):
        assert (table["dpm@50 (--dpm-solver)"]["rms_vs_truth"]
                <= 1.2 * table["ddim250 (reference default)"]["rms_vs_truth"]), table

    def test_dpm50_far_better_than_ddim50(self, table):
        assert (table["dpm@50 (--dpm-solver)"]["rms_vs_truth"]
                < 0.35 * table["ddim50"]["rms_vs_truth"]), table

    def test_fast_guidance_gap_is_semantic_not_discretization(self, table):
        f250 = table["fast@250 (--fast-guidance)"]["rms_vs_truth"]
        f50 = table["fast@50 (--fast-guidance)"]["rms_vs_truth"]
        assert f250 > 3.0 * table["ddim250 (reference default)"]["rms_vs_truth"], table
        assert abs(f250 - f50) < 0.5 * f250, table

    def test_fast_guidance_still_reaches_the_objective(self, table):
        truth, f250 = table["truth (ddim1000)"], table["fast@250 (--fast-guidance)"]
        assert f250["clip_objective"] < 3.0 * max(truth["clip_objective"], 1e-3), table
        assert abs(f250["prior_fit"] - 1.0) < 0.3, table

    def test_progressive_cutout_nearly_free(self, flag_table):
        m, base = flag_table["--progressive-cutout"], flag_table["baseline ddim250 (flags off)"]
        assert m["rms_vs_baseline"] < 0.02, flag_table
        assert abs(m["clip_objective"] - base["clip_objective"]) < 0.05 * base["clip_objective"]

    def test_reduce_clip_bounded_tradeoff(self, flag_table):
        m, base = flag_table["--reduce-clip"], flag_table["baseline ddim250 (flags off)"]
        assert m["rms_vs_baseline"] < 0.08, flag_table
        assert m["clip_objective"] < 1.25 * base["clip_objective"], flag_table

    def test_cached_cutouts_is_the_costliest_flag(self, flag_table):
        """Cached cutouts move the endpoint the most and raise the
        held-out objective over the baseline's (1.9392 against 1.7868 on
        the CPU). The objective half depends on which coordinates are
        drawn: on another stream (a numpy ``RandomState`` keyed on (123,
        ref_t)) it read 1.8228 against 1.8359."""
        cached = flag_table["--cached-cutouts"]
        assert cached["rms_vs_baseline"] > flag_table["--reduce-clip"]["rms_vs_baseline"]
        assert cached["rms_vs_baseline"] > flag_table["--progressive-cutout"]["rms_vs_baseline"]
        assert cached["clip_objective"] > flag_table["baseline ddim250 (flags off)"]["clip_objective"]

    def test_flags_stay_near_prior(self, flag_table):
        for arm, m in flag_table.items():
            assert abs(m["prior_fit"] - 1.0) < 0.3, (arm, m)


def test_the_flag_table_is_the_jax_tools(jq, flag_table):
    """The port's flag table against the JAX tool's ``compute_flag_table``
    (ddim250, five arms, the same coordinates): every entry within relative
    REL_TOL (f32 rounding through 250 guided steps; measured <= 2e-6)."""
    want = jq.compute_flag_table()
    assert set(flag_table) == set(want)
    for arm, m in want.items():
        for key, ref in m.items():
            np.testing.assert_allclose(flag_table[arm][key], ref, rtol=REL_TOL, atol=0,
                                       err_msg=f"{arm}: {key}")
