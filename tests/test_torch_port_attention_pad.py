"""The attention wrappers' zero-padding of a head dim between the kernels'
templates (the toy models' d = 16, any d up to 256), on the CPU: the
wrapper's own ``fwd_padded`` / ``bwd_padded`` with the plain attention at
the padded width standing in for the kernel (it takes the kernel's contract:
the template width dk, the logits scaled by the true d's 1/sqrt(d)), held
to the plain attention at the true width.

Tolerance: f32 on both sides, the same products summed over dk - d more
zeros: rtol / atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch.kernels import attention as kattn  # noqa: E402

torch.set_num_threads(2)


def _plain_fwd_kernel(qkv, heads, dk, dh):
    assert qkv.shape[-1] == 3 * heads * dk
    q, k, _ = kattn.split_heads(qkv, heads)
    out = kattn.merge_heads(kattn.attention_fwd_plain(*kattn.split_heads(qkv, heads), dh=dh),
                            qkv.shape[0])
    lse = torch.logsumexp((q @ k.transpose(-1, -2)) / dh ** 0.5, -1)
    return out, lse


def _plain_bwd_kernel(qkv, out, lse, g, heads, dk, dh):
    b = qkv.shape[0]
    assert out.shape[-1] == g.shape[-1] == heads * dk
    grads = kattn.attention_bwd_plain(*kattn.split_heads(qkv, heads), kattn.to_heads(g, heads),
                                      dh=dh)
    return torch.cat([kattn.merge_heads(z, b) for z in grads], dim=-1)


@pytest.mark.parametrize("d,dk", [(8, 64), (16, 64), (32, 64), (40, 64), (64, 64), (72, 128),
                                  (100, 128), (160, 192), (200, 256), (256, 256)])
def test_the_kernel_width_of_a_head_dim(d, dk):
    assert kattn.kernel_head_dim(d) == dk


def test_a_head_dim_past_the_widest_template_raises():
    with pytest.raises(ValueError, match="head dim 264"):
        kattn.kernel_head_dim(264)


def test_pad_heads_puts_zeros_after_each_head():
    x = torch.arange(2 * 3 * 6, dtype=torch.float32).reshape(2, 3, 6)  # 3 groups of 2
    p = kattn.pad_heads(x, 3, 2, 4)
    assert p.shape == (2, 3, 12) and p.is_contiguous()
    np.testing.assert_array_equal(p.reshape(2, 3, 3, 4)[..., :2].numpy(), x.reshape(2, 3, 3, 2))
    assert not p.reshape(2, 3, 3, 4)[..., 2:].any()
    assert torch.equal(kattn.unpad_heads(p, 3, 2, 4), x)
    # one group (one head): still contiguous, as the kernels take out and g
    one = kattn.unpad_heads(kattn.pad_heads(x[..., :2], 1, 2, 4), 1, 2, 4)
    assert one.is_contiguous() and torch.equal(one, x[..., :2])


@pytest.mark.parametrize("b,heads,t,d", [(1, 2, 64, 16), (2, 1, 77, 16), (1, 2, 100, 32),
                                         (1, 3, 50, 40), (2, 2, 30, 200)])
def test_padded_wrappers_match_the_plain_attention(b, heads, t, d):
    rs = np.random.RandomState(d + t)
    qkv = torch.from_numpy(rs.randn(b, t, 3 * heads * d).astype(np.float32))
    g = torch.from_numpy(rs.randn(b, t, heads * d).astype(np.float32))
    dk = kattn.kernel_head_dim(d)
    q, k, v = kattn.split_heads(qkv, heads)

    out, lse = kattn.fwd_padded(qkv, heads, d, dk, _plain_fwd_kernel)
    want = kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), b)
    assert out.shape == (b, t, heads * d)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp((q @ k.transpose(-1, -2)) / d ** 0.5, -1),
                               rtol=1e-5, atol=1e-5)

    dqkv = kattn.bwd_padded(qkv, out, lse, g, heads, d, dk, _plain_bwd_kernel)
    assert dqkv.shape == qkv.shape
    refs = kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g, heads))
    for got, ref in zip(dqkv.chunk(3, dim=-1), refs):
        torch.testing.assert_close(got, kattn.merge_heads(ref, b), rtol=1e-5, atol=1e-5)


def test_the_scale_is_the_true_head_dims():
    """Padded at the template's own scale, the logits would shrink by
    sqrt(d / dk): the result differs."""
    rs = np.random.RandomState(0)
    qkv = torch.from_numpy(rs.randn(1, 64, 3 * 16).astype(np.float32)) * 3
    wrong = kattn.fwd_padded(qkv, 1, 16, 64, lambda x, h, dk, dh: _plain_fwd_kernel(x, h, dk, dk))
    right = kattn.fwd_padded(qkv, 1, 16, 64, _plain_fwd_kernel)
    want = kattn.attention_fwd_plain(*kattn.split_heads(qkv, 1))
    torch.testing.assert_close(right[0], want, rtol=1e-5, atol=1e-5)
    assert (wrong[0] - want).abs().max() > 1e-2
