"""The port's 3x3 conv family (cgd_tpu_torch.kernels.conv3x3) against the JAX
package's Pallas kernels run in interpret mode, at small shapes, in f32.

On the CPU the port's wrappers take their plain PyTorch versions, so this pins
the arithmetic each CUDA kernel must reproduce, and the backward
decomposition of the autograd Functions (transpose conv with flipped weights,
the fused silu'/affine dx, the nearest-2x adjoint). Tolerances are the JAX
package's own for its kernel against XLA (tests/test_pallas_conv.py):
forward atol 2e-4 / rtol 1e-4, input gradients atol 5e-4 / rtol 1e-3.
The kernels themselves run only on a CUDA card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from cgd_tpu.kernels import conv_pallas as cp  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402

torch.set_num_threads(2)

FWD = dict(atol=2e-4, rtol=1e-4)
GRAD = dict(atol=5e-4, rtol=1e-3)

# (b, h, w, cin, cout): skinny RGB input, eps+sigma output, cin != cout
SHAPES = [
    (1, 8, 16, 3, 32),
    (1, 8, 16, 32, 6),
    (2, 8, 8, 64, 32),
]


def _inputs(shape, seed, up=False):
    b, h, w, ci, co = shape
    rs = np.random.RandomState(seed)
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    return dict(
        x=rs.randn(b, h, w, ci).astype(np.float32),
        w=(rs.randn(3, 3, ci, co) / np.sqrt(9 * ci)).astype(np.float32),
        bias=(0.1 * rs.randn(co)).astype(np.float32),
        A=(1.0 + 0.2 * rs.randn(b, ci)).astype(np.float32),
        B=(0.2 * rs.randn(b, ci)).astype(np.float32),
        skip=rs.randn(b, ho, wo, co).astype(np.float32),
        probe=rs.randn(b, ho, wo, co).astype(np.float32),
    )


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


# name -> (JAX function, port function, argument names)
VARIANTS = {
    "conv3x3": (cp.conv3x3, k3.conv3x3, ("x", "w", "bias")),
    "gn_silu": (cp.conv3x3_gn_silu, k3.conv3x3_gn_silu, ("x", "A", "B", "w", "bias")),
    "gn_silu_add": (cp.conv3x3_gn_silu_add, k3.conv3x3_gn_silu_add,
                    ("x", "A", "B", "w", "bias", "skip")),
    "gn_silu_up": (cp.conv3x3_gn_silu_up, k3.conv3x3_gn_silu_up, ("x", "A", "B", "w", "bias")),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_pallas(variant, shape):
    jfn, tfn, names = VARIANTS[variant]
    d = _inputs(shape, 0, up=variant == "gn_silu_up")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfn(*(jnp.asarray(d[n]) for n in names)))
    with torch.no_grad():
        ours = tfn(*(_t(d[n]) for n in names)).numpy()
    np.testing.assert_allclose(ours, ref, **FWD)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_input_gradients_match_jax_grad(variant, shape):
    """Gradients of sum(sin(f) * probe) with respect to every non-weight
    input: x, and A/B (which carry the GroupNorm statistics) and skip."""
    jfn, tfn, names = VARIANTS[variant]
    d = _inputs(shape, 1, up=variant == "gn_silu_up")
    wrt = [i for i, n in enumerate(names) if n in ("x", "A", "B", "skip")]
    probe = d["probe"]

    def jloss(*args):
        return jnp.sum(jnp.sin(jfn(*args)) * probe)

    with pltpu.force_tpu_interpret_mode():
        gj = jax.grad(jloss, tuple(wrt))(*(jnp.asarray(d[n]) for n in names))
    args = [_t(d[n], grad=i in wrt) for i, n in enumerate(names)]
    (torch.sin(tfn(*args)) * _t(probe)).sum().backward()
    for i, g in zip(wrt, gj):
        np.testing.assert_allclose(args[i].grad.numpy(), np.asarray(g), err_msg=names[i], **GRAD)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_dx_matches_pallas(shape):
    """K-dx's plain version against the Pallas one-pass backward
    (dx, dA, dB) on the same flipped/transposed weights."""
    d = _inputs(shape, 2)
    b, h, w, ci, co = shape
    g = np.random.RandomState(3).randn(b, h, w, co).astype(np.float32)
    wt = np.ascontiguousarray(np.flip(d["w"], (0, 1)).swapaxes(2, 3))
    with pltpu.force_tpu_interpret_mode():
        ref = cp._conv3x3_dx_pallas(*(jnp.asarray(a) for a in (g, wt, d["x"], d["A"], d["B"])))
    ours = k3.conv3x3_dx(*(_t(a) for a in (g, wt, d["x"], d["A"], d["B"])))
    for name, o, r in zip(("dx", "dA", "dB"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, **GRAD)


def test_weight_and_bias_gradients_match_jax_grad():
    """dw/db are plain PyTorch, computed only when asked for."""
    d = _inputs((1, 8, 16, 32, 32), 4)
    names = ("x", "A", "B", "w", "bias", "skip")

    def jloss(w_, b_):
        args = [jnp.asarray(d[n]) for n in names]
        args[3], args[4] = w_, b_
        return jnp.sum(jnp.cos(cp.conv3x3_gn_silu_add(*args)))

    with pltpu.force_tpu_interpret_mode():
        gw, gb = jax.grad(jloss, (0, 1))(jnp.asarray(d["w"]), jnp.asarray(d["bias"]))
    args = [_t(d[n], grad=n in ("w", "bias")) for n in names]
    torch.cos(k3.conv3x3_gn_silu_add(*args)).sum().backward()
    np.testing.assert_allclose(args[3].grad.numpy(), np.asarray(gw), **GRAD)
    np.testing.assert_allclose(args[4].grad.numpy(), np.asarray(gb), **GRAD)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    d = _inputs((1, 8, 8, 32, 32), 5)
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(_t(d["x"]), _t(d["w"]), _t(d["bias"]), _t(d["A"]), _t(d["B"]))
    ref = k3.conv3x3_fwd_plain(_t(d["x"]), _t(d["w"]), _t(d["bias"]), _t(d["A"]), _t(d["B"]))
    assert torch.equal(out, ref)
    assert k3.LAUNCHES == {"conv3x3_fwd": 0, "conv3x3_fwd_halo": 0, "conv3x3_dx": 0,
                           "conv3x3_dx_wtiled": 0, "conv3x3_fwd_f32": 0,
                           "conv3x3_fwd_halo_f32": 0, "conv3x3_dx_f32": 0}
    k3.conv3x3_fwd(_t(d["x"]).float(), _t(d["w"]).float(), _t(d["bias"]).float())
    k3.conv3x3_fwd(_t(d["x"]).float(), _t(d["w"]).float(), _t(d["bias"]).float(), _t(d["A"]),
                   _t(d["B"]), up=True)
    rows = _t(d["x"]).float()[:, :1]
    k3.conv3x3_fwd(_t(d["x"]).float(), _t(d["w"]).float(), _t(d["bias"]).float(), _t(d["A"]),
                   _t(d["B"]), etop=rows, ebot=rows)
    assert not any(k3.LAUNCHES.values())  # f32 on the CPU: the plain version too


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(1, 8, 8, 32, device="meta")
    w = torch.empty(3, 3, 32, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k3.conv3x3_fwd(x, w, torch.empty(32, device="meta"))
