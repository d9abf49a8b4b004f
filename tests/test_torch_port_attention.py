"""The port's attention against cgd_tpu's, in f32 on the CPU.

- ``attention_fwd_plain`` / ``attention_bwd_plain`` (the math K-attn-f and
  K-attn-b are held to on the card) against the Pallas kernel
  ``flash_mha(..., interpret=True)`` and its ``jax.vjp``;
- the port's default ``qkv_attention`` (the kernel route: on a CPU tensor,
  the kernels' plain versions behind the autograd Function) against JAX's
  ``qkv_attention`` with ``CGD_TPU_PALLAS_ATTN=1``, forward and gradient;
- under ``kernel_routing("plain")``, against JAX's default einsum chain.

Tolerance: atol 1e-5 / rtol 1e-4 (the same f32 math, summed in another
order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.kernels.attention_pallas import flash_mha  # noqa: E402
from cgd_tpu.ops import nn as jnn  # noqa: E402
from cgd_tpu_torch.kernels import attention as kattn  # noqa: E402
from cgd_tpu_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)


def _qkv(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_plain_versions_match_flash_mha_interpret(d):
    q, k, v, g = (_qkv((3, 24, d), s) for s in range(4))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: flash_mha(a, b, c, True), jq, jk, jv)
    grads = vjp(jnp.asarray(g))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(kattn.attention_fwd_plain(tq, tk, tv).numpy(), np.asarray(out), **TOL)
    for name, ours, ref in zip("qkv", kattn.attention_bwd_plain(tq, tk, tv, torch.from_numpy(g)), grads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=f"d{name}", **TOL)


def _jax_and_port(heads, seed, plain):
    qkv = _qkv((2, 20, 3 * 64), seed)
    probe = _qkv((2, 20, 64), seed + 1)

    def jloss(x):
        out = jnn.qkv_attention(x, heads)
        return jnp.sum(out * probe), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_(True)
    if plain:
        with tnn.kernel_routing("plain"):
            out = tnn.qkv_attention(x, heads)
    else:
        out = tnn.qkv_attention(x, heads)
    (out * torch.from_numpy(probe)).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), np.asarray(jout), np.asarray(jgrad)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_default_route_matches_jax_pallas_attention(monkeypatch, heads):
    monkeypatch.setenv("CGD_TPU_PALLAS_ATTN", "1")
    kattn.reset_launch_counts()
    out, grad, jout, jgrad = _jax_and_port(heads, 3, plain=False)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)
    assert kattn.LAUNCHES == {"attn_fwd": 0, "attn_bwd": 0}  # CPU tensors launch nothing


@pytest.mark.parametrize("heads", [1, 2])
def test_plain_routing_matches_jax_default_attention(monkeypatch, heads):
    monkeypatch.delenv("CGD_TPU_PALLAS_ATTN", raising=False)
    out, grad, jout, jgrad = _jax_and_port(heads, 5, plain=True)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)


def test_head_layout_helpers_round_trip():
    qkv = torch.from_numpy(_qkv((2, 7, 3 * 48), 9))
    q, k, v = kattn.split_heads(qkv, 3)
    assert q.shape == (6, 7, 16)
    assert torch.equal(kattn.merge_heads(k, 2), qkv[..., 48:96])
    assert torch.equal(kattn.to_heads(qkv[..., :48], 3), q)


def test_other_devices_raise_instead_of_falling_back():
    qkv = torch.empty(1, 16, 3 * 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kattn.attention_fwd(qkv, 1)
