"""The port's guidance pieces against cgd_tpu.guidance on the same numpy
inputs, in f32 on the CPU: the four losses, and the box-filter cutouts
(forward and the gradient with respect to the image, which carries the
guidance gradient back to x). Cutout coordinates come from a torch
Generator in the port and from jax.random in the reference, so their draw is
checked for the reference's distribution bounds, not for equal numbers.
Tolerance: atol 1e-5 / rtol 1e-5 (f32, the same arithmetic in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.guidance import cutouts as jcut  # noqa: E402
from cgd_tpu.guidance import losses as jlosses  # noqa: E402
from cgd_tpu_torch.guidance import cutouts as tcut  # noqa: E402
from cgd_tpu_torch.guidance import losses as tlosses  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["range_loss", "tv_loss", "saturation_loss"])
def test_image_losses_match_jax(name):
    x = (1.5 * np.random.RandomState(0).randn(2, 9, 7, 3)).astype(np.float32)
    ref = getattr(jlosses, name)(jnp.asarray(x))
    ours = getattr(tlosses, name)(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_spherical_dist_loss_matches_jax_with_broadcast():
    rs = np.random.RandomState(1)
    x, y = rs.randn(4, 2, 1, 16).astype(np.float32), rs.randn(1, 1, 3, 16).astype(np.float32)
    ref = jlosses.spherical_dist_loss(jnp.asarray(x), jnp.asarray(y))
    ours = tlosses.spherical_dist_loss(torch.from_numpy(x), torch.from_numpy(y))
    assert ours.shape == (4, 2, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_make_cutouts_and_image_gradient_match_jax():
    rs = np.random.RandomState(2)
    img = rs.randn(2, 20, 24, 3).astype(np.float32)
    size = np.array([20.0, 11.0, 8.0], np.float32)
    spec = (np.array([0.0, 13.0, 16.0], np.float32), np.array([0.0, 9.0, 5.0], np.float32), size)
    probe = rs.randn(6, 8, 8, 3).astype(np.float32)

    def jloss(im):
        out = jcut.make_cutouts(im, jcut.CutoutSpec(*map(jnp.asarray, spec)), 8)
        return jnp.sum(out * probe), out

    (_, ref), gref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(img))
    it = torch.from_numpy(img).requires_grad_(True)
    out = tcut.make_cutouts(it, tcut.CutoutSpec(*map(torch.from_numpy, spec)), 8)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(gref), **TOL)


@pytest.mark.parametrize("cut_pow", [1.0, 0.5])
def test_cutout_coords_follow_the_reference_distribution(cut_pow):
    side_x, side_y, cut = 40, 32, 16
    spec = tcut.sample_cutout_coords(torch.Generator().manual_seed(0), 64, side_x, side_y,
                                     cut, cut_pow)
    again = tcut.sample_cutout_coords(torch.Generator().manual_seed(0), 64, side_x, side_y,
                                      cut, cut_pow)
    assert all(torch.equal(a, b) for a, b in zip(spec, again))
    size, ox, oy = spec.size, spec.offset_x, spec.offset_y
    for v in (size, ox, oy):
        assert v.dtype == torch.float32 and v.shape == (64,)
        assert torch.equal(v, v.floor())
    assert size.min() >= cut and size.max() <= min(side_x, side_y)
    assert ox.min() >= 0 and (ox + size).max() <= side_x
    assert oy.min() >= 0 and (oy + size).max() <= side_y
    assert len(set(size.tolist())) > 8  # a spread of sizes, not one value
