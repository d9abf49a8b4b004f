"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a card every test skips (the kernels have no CPU
mode). This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Bound: max |err| <= 1% of the reference's max |value| in bf16 (the order of
bf16 rounding; the two round at different points).
"""

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch.kernels import attention as kattn  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
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
    assert k3.LAUNCHES == {"conv3x3_fwd": 1, "conv3x3_dx": 1, "conv3x3_dx_wtiled": 0}
    assert x.grad.dtype == torch.bfloat16 and A.grad.dtype == torch.float32


def test_f32_raises_with_the_dtype_named(dev):
    d = _inputs(dev, 1, 8, 32, 32)
    with pytest.raises(TypeError, match="float32"):
        k3.conv3x3_fwd(d["x"].float(), d["w"], d["bias"])


def _rn(dev, *shape, scale=1.0, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


# (batch, H, W, Cin, Cout): the 512^2 width, ragged 8 x 16 tiles, skinny channels
WTILED = [(1, 64, 512, 128, 128), (1, 24, 40, 64, 96), (2, 9, 33, 32, 8)]


@pytest.mark.parametrize("shape", WTILED)
def test_kdx_wtiled_matches_plain_and_is_deterministic(dev, shape):
    b, h, w, ci, co = shape
    x, g = _rn(dev, b, h, w, ci, seed=1), _rn(dev, b, h, w, co, seed=2)
    wt = k3._flip_t(_rn(dev, 3, 3, ci, co, scale=(9 * ci) ** -0.5, seed=3))
    A = 1.0 + 0.2 * _rn(dev, b, ci, seed=4).float()
    B = 0.2 * _rn(dev, b, ci, seed=5).float()
    k3.reset_launch_counts()
    got = k3.conv3x3_dx(g, wt, x, A, B, wtiled=True)
    again = k3.conv3x3_dx(g, wt, x, A, B, wtiled=True)
    assert k3.LAUNCHES == {"conv3x3_fwd": 0, "conv3x3_dx": 0, "conv3x3_dx_wtiled": 2}
    for a, ref, c in zip(got, k3.conv3x3_dx_plain(g, wt, x, A, B), again):
        _close(a, ref)
        assert torch.equal(a, c)


def test_kdx_takes_the_wtiled_mode_at_512_wide_images(dev):
    d = {k: v[:, :64] if v.dim() == 4 else v for k, v in _inputs(dev, 1, 512, 64, 64).items()}
    k3.reset_launch_counts()
    k3.conv3x3_dx(d["g"], k3._flip_t(d["w"]), d["x"], d["A"], d["B"])
    assert k3.LAUNCHES["conv3x3_dx_wtiled"] == 1 and k3.LAUNCHES["conv3x3_dx"] == 0


# (batch, heads, T, head dim): the UNet's T = 1024 / 64 at d = 64, ragged T,
# and the other head dims (the 128px model)
ATTN = [(1, 8, 1024, 64), (1, 16, 64, 64), (2, 3, 100, 64), (1, 4, 256, 128), (1, 2, 77, 192),
        (2, 2, 45, 256)]


@pytest.mark.parametrize("b,h,t,d", ATTN)
def test_attention_kernels_match_plain_and_backward_is_deterministic(dev, b, h, t, d):
    qkv, g = _rn(dev, b, t, 3 * h * d, seed=6), _rn(dev, b, t, h * d, seed=7)
    kattn.reset_launch_counts()
    out, lse = kattn.attention_fwd(qkv, h)
    q, k, v = kattn.split_heads(qkv, h)
    _close(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), b))
    dqkv = kattn.attention_bwd(qkv, out, lse, g, h)
    assert torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, h))
    refs = kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g, h))
    for got, ref in zip(dqkv.chunk(3, dim=-1), refs):
        _close(got, kattn.merge_heads(ref, b))
    assert kattn.LAUNCHES == {"attn_fwd": 1, "attn_bwd": 2}


def test_attention_function_uses_the_kernels(dev):
    qkv = _rn(dev, 1, 256, 3 * 512, seed=8).requires_grad_(True)
    kattn.reset_launch_counts()
    out = kattn.qkv_attention(qkv, 8)
    out.float().sum().backward()
    assert kattn.LAUNCHES == {"attn_fwd": 1, "attn_bwd": 1}
    assert out.dtype == qkv.grad.dtype == torch.bfloat16


def test_attention_unsupported_head_dim_or_dtype_raises(dev):
    with pytest.raises(ValueError, match="head dim 32"):
        kattn.attention_fwd(_rn(dev, 1, 16, 3 * 64), 2)
    with pytest.raises(TypeError, match="float32"):
        kattn.attention_fwd(_rn(dev, 1, 16, 3 * 64).float(), 1)
