"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a card every test skips (the kernels have no CPU
mode). This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Bound: max |err| <= 1% of the reference's max |value| in bf16 (the order of
bf16 rounding; the two round at different points).
"""

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close(a, b):
    assert (a.float() - b.float()).abs().max() <= TOL * b.float().abs().max()


def _inputs(dev, b, h, ci, co, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)

    return dict(
        x=rn(b, h, h, ci), w=rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), bias=rn(co, scale=0.1),
        A=1.0 + 0.2 * torch.randn(b, ci, generator=gen, device=dev),
        B=0.2 * torch.randn(b, ci, generator=gen, device=dev),
        skip=rn(b, h, h, co), up_skip=rn(b, 2 * h, 2 * h, co), g=rn(b, h, h, co),
    )


# (batch, H, Cin, Cout): ragged M and N tiles, skinny channels, split-K sizes
SHAPES = [(2, 24, 64, 96), (1, 16, 3, 256), (1, 32, 256, 6), (1, 8, 1024, 512)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["plain", "prologue", "skip", "up"])
def test_kfwd_matches_plain(dev, shape, variant):
    d = _inputs(dev, *shape)
    A, B = (None, None) if variant == "plain" else (d["A"], d["B"])
    skip = d["skip"] if variant == "skip" else None
    up = variant == "up"
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(d["x"], d["w"], d["bias"], A, B, skip, up)
    assert k3.LAUNCHES["conv3x3_fwd"] == 1
    _close(out, k3.conv3x3_fwd_plain(d["x"], d["w"], d["bias"], A, B, skip, up))


@pytest.mark.parametrize("shape", SHAPES)
def test_kdx_matches_plain_and_is_deterministic(dev, shape):
    d = _inputs(dev, *shape)
    wt = k3._flip_t(d["w"])
    got = k3.conv3x3_dx(d["g"], wt, d["x"], d["A"], d["B"])
    again = k3.conv3x3_dx(d["g"], wt, d["x"], d["A"], d["B"])
    for a, b, c in zip(got, k3.conv3x3_dx_plain(d["g"], wt, d["x"], d["A"], d["B"]), again):
        _close(a, b)
        assert torch.equal(a, c)


def test_autograd_functions_use_the_kernels(dev):
    d = _inputs(dev, 1, 16, 64, 64)
    x = d["x"].clone().requires_grad_(True)
    A = d["A"].clone().requires_grad_(True)
    k3.reset_launch_counts()
    out = k3.conv3x3_gn_silu_add(x, A, d["B"], d["w"], d["bias"], d["skip"])
    out.float().sum().backward()
    assert k3.LAUNCHES == {"conv3x3_fwd": 1, "conv3x3_dx": 1}
    assert x.grad.dtype == torch.bfloat16 and A.grad.dtype == torch.float32


def test_f32_raises_with_the_dtype_named(dev):
    d = _inputs(dev, 1, 8, 32, 32)
    with pytest.raises(TypeError, match="float32"):
        k3.conv3x3_fwd(d["x"].float(), d["w"], d["bias"])
