"""cgd_tpu_torch.ops.nn against cgd_tpu.ops.nn on the same numpy inputs, in
f32 on the CPU: GroupNorm, the fused GN -> SiLU -> conv (including the
gradient through the GN statistics folded into A/B), attention, the timestep
embedding and the 2x resamples. The JAX side runs its XLA path (its CPU
default); the port runs its kernel route, whose conv family takes the plain
versions on CPU tensors. Tolerances: forward atol 2e-4 / rtol 1e-4, gradients
atol 5e-4 / rtol 1e-3 (the JAX package's own, tests/test_pallas_conv.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.ops import nn as jnn  # noqa: E402
from cgd_tpu_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(2)

FWD = dict(atol=2e-4, rtol=1e-4)
GRAD = dict(atol=5e-4, rtol=1e-3)


def _rs(seed):
    return np.random.RandomState(seed)


def _ns(d):
    """JAX param dict -> the port's attribute-style params (torch)."""
    return SimpleNamespace(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


def _jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _norm(c, seed):
    rs = _rs(seed)
    return {"scale": (1.0 + 0.1 * rs.randn(c)).astype(np.float32),
            "bias": (0.1 * rs.randn(c)).astype(np.float32)}


def _conv(kh, ci, co, seed):
    rs = _rs(seed)
    return {"kernel": (rs.randn(kh, kh, ci, co) / np.sqrt(kh * kh * ci)).astype(np.float32),
            "bias": (0.1 * rs.randn(co)).astype(np.float32)}


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 32), ((1, 16, 48), 32), ((1, 4, 4, 24), 32)])
def test_group_norm(shape, groups):
    x = (3.0 + 2.0 * _rs(0).randn(*shape)).astype(np.float32)
    p = _norm(shape[-1], 1)
    ref = jnn.group_norm(_jx(p), jnp.asarray(x), groups)
    ours = tnn.group_norm(_ns(p), torch.from_numpy(x), groups)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("resample,with_emb_and_skip",
                         [("", False), ("", True), ("up", False), ("down", False)])
def test_fused_gn_silu_conv_forward_and_gradients(resample, with_emb_and_skip):
    """Forward, and the gradient with respect to x (through the GN stats),
    the emb scale/shift and the skip, against jax.grad of the JAX op (the
    resample convs of the up/down ResBlocks take no scale-shift or skip)."""
    b, h, w, ci, co = 2, 8, 8, 64, 32
    rs = _rs(2)
    x = rs.randn(b, h, w, ci).astype(np.float32)
    norm, conv = _norm(ci, 3), _conv(3, ci, co, 4)
    ho = {"up": 2 * h, "down": h // 2}.get(resample, h)
    probe = rs.randn(b, ho, ho, co).astype(np.float32)
    extra = {}
    if with_emb_and_skip:
        extra = {"scale": 0.1 * rs.randn(b, 1, 1, ci).astype(np.float32),
                 "shift": 0.1 * rs.randn(b, 1, 1, ci).astype(np.float32),
                 "skip": rs.randn(b, h, w, co).astype(np.float32)}

    def jloss(x_, ex):
        kw = {}
        if ex:
            kw = {"scale_shift": (ex["scale"], ex["shift"]), "skip": ex["skip"]}
        out = jnn.fused_gn_silu_conv(_jx(norm), _jx(conv), x_, resample=resample, **kw)
        return jnp.sum(jnp.sin(out) * probe), out

    (_, ref), gj = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), _jx(extra))

    xt = torch.from_numpy(x).requires_grad_(True)
    ext = {k: torch.from_numpy(v).requires_grad_(True) for k, v in extra.items()}
    kw = {"scale_shift": (ext["scale"], ext["shift"]), "skip": ext["skip"]} if ext else {}
    out = tnn.fused_gn_silu_conv(_ns(norm), _ns(conv), xt, resample=resample, **kw)
    (torch.sin(out) * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[0]), **GRAD)
    for k, v in ext.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(gj[1][k]), err_msg=k, **GRAD)


def test_fused_matches_plain_routing():
    """The kernel route (A/B fold) and conv_routing("plain") (unfused chain)
    compute the same function."""
    rs = _rs(5)
    x = torch.from_numpy(rs.randn(1, 8, 16, 32).astype(np.float32))
    norm, conv = _ns(_norm(32, 6)), _ns(_conv(3, 32, 48, 7))
    fused = tnn.fused_gn_silu_conv(norm, conv, x)
    with tnn.conv_routing("plain"):
        plain = tnn.fused_gn_silu_conv(norm, conv, x)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), **FWD)
    with pytest.raises(ValueError):
        with tnn.conv_routing("spmd"):
            pass


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_conv2d(k, stride):
    x = _rs(8).randn(1, 8, 8, 16).astype(np.float32)
    p = _conv(k, 16, 24, 9)
    ref = jnn.conv2d(_jx(p), jnp.asarray(x), stride=stride)
    ours = tnn.conv2d(_ns(p), torch.from_numpy(x), stride=stride)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FWD)


def test_dense():
    rs = _rs(10)
    x = rs.randn(3, 5, 16).astype(np.float32)
    p = {"kernel": rs.randn(16, 8).astype(np.float32), "bias": rs.randn(8).astype(np.float32)}
    np.testing.assert_allclose(tnn.dense(_ns(p), torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.dense(_jx(p), jnp.asarray(x))), **FWD)


@pytest.mark.parametrize("heads", [1, 4])
def test_qkv_attention(heads):
    qkv = _rs(11).randn(2, 16, 3 * 32).astype(np.float32)
    ref = jnn.qkv_attention(jnp.asarray(qkv), heads)
    ours = tnn.qkv_attention(torch.from_numpy(qkv), heads)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0.0, 5.0, 999.0], np.float32)
    ref = jnn.timestep_embedding(jnp.asarray(t), dim)
    ours = tnn.timestep_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


def test_resamples():
    x = _rs(12).randn(2, 8, 6, 5).astype(np.float32)
    np.testing.assert_array_equal(tnn.upsample_nearest_2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnn.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_allclose(tnn.avg_pool_2x(torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.avg_pool_2x(jnp.asarray(x))), **FWD)


def test_cast_conv_params_casts_only_conv_leaves():
    from cgd_tpu_torch.models.unet import UNet, UNetConfig

    cfg = UNetConfig(image_size=16, model_channels=32, num_res_blocks=1,
                     attention_ds=(2,), channel_mult=(1, 2), num_head_channels=16)
    unet = UNet(cfg, device="meta")
    tnn.cast_conv_params(unet, torch.bfloat16)
    for name, p in unet.named_parameters():
        conv = name.endswith(("conv.kernel", "conv.bias", "skip.kernel", "skip.bias",
                              "conv_in.kernel", "conv_in.bias"))
        assert p.dtype == (torch.bfloat16 if conv else torch.float32), name
