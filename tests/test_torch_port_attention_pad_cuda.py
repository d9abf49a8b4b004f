"""K-attn-f and K-attn-b at head dims between the kernels' templates (the
toy models' d = 16, and 32, 40, 200), bf16 and f32, against their plain
versions on a card: the wrappers zero-pad each head to the next template
and keep the true d's 1/sqrt(d) scale.

Marked ``cuda``; imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_attention_pad_cuda.py

Bounds: max |err| <= 1% of the reference's max |value| in bf16, 1e-5 in
f32 (3xTF32 against f32), as tests/test_torch_port_cuda.py.
"""

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch.kernels import attention as kattn  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close(a, b, dtype):
    assert a.dtype == dtype
    assert (a.float() - b.float()).abs().max() <= TOL[dtype] * b.float().abs().max()


# (batch, heads, T, d): the toy 64px UNet's attention (four heads of 16 at
# 32^2), ragged T, d = 32 and 40, and a d between the widest templates
PAD = [(1, 4, 1024, 16), (2, 1, 77, 16), (1, 4, 64, 32), (1, 2, 300, 32), (2, 3, 100, 40),
       (1, 2, 130, 200)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,t,d", PAD)
def test_padded_head_dims_match_plain(dev, dtype, b, h, t, d):
    gen = torch.Generator(dev).manual_seed(d + t)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev).to(dtype)
    g = torch.randn(b, t, h * d, generator=gen, device=dev).to(dtype)
    kattn.reset_launch_counts()
    out, lse = kattn.attention_fwd(qkv, h)
    q, k, v = kattn.split_heads(qkv, h)
    assert out.shape == (b, t, h * d)
    _close(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), b), dtype)
    logits = (q.float() @ k.float().transpose(-1, -2)) / d ** 0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                               atol=1e-3 if dtype == torch.bfloat16 else 1e-5, rtol=0)
    dqkv = kattn.attention_bwd(qkv, out, lse, g, h)
    assert torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, h))
    refs = kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g, h))
    for got, ref in zip(dqkv.chunk(3, dim=-1), refs):
        _close(got, kattn.merge_heads(ref, b), dtype)
    name = "" if dtype == torch.bfloat16 else "_f32"
    want = {"attn_fwd": 0, "attn_bwd": 0, "attn_fwd_f32": 0, "attn_bwd_f32": 0,
            f"attn_fwd{name}": 1, f"attn_bwd{name}": 2}
    assert kattn.LAUNCHES == want and kattn.LAUNCHES_BY_D[d] == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_toy_unets_attention_runs_on_the_kernels(dev, dtype):
    """qkv_attention at the toy UNet's d = 16 through autograd: the kernels
    launch under d = 16 and the input gradient matches the plain one."""
    gen = torch.Generator(dev).manual_seed(5)
    qkv = torch.randn(1, 256, 3 * 64, generator=gen, device=dev).to(dtype).requires_grad_(True)
    kattn.reset_launch_counts()
    out = kattn.qkv_attention(qkv, 4)
    (grad,) = torch.autograd.grad(out.float().square().sum(), qkv)
    assert sum(kattn.LAUNCHES_BY_D[16].values()) == 2
    ref = qkv.detach().float().cpu().requires_grad_(True)
    rout = kattn.qkv_attention(ref, 4)
    (rgrad,) = torch.autograd.grad(rout.square().sum(), ref)
    _close(out, rout.to(dev), dtype)
    _close(grad, rgrad.to(dev), dtype)
