"""The port's ADM UNet against cgd_tpu.models.unet.apply_unet on the same
weights (carried across by cgd_tpu_torch.convert.from_jax), in f32 on the CPU.

Every parameter, including the zero-init out_convs and attention
projections, is perturbed before the comparison: a zero out_conv would hide
bugs in the fused prologue/epilogue path it feeds. Tolerance: atol and rtol
1e-3 for the output and the input gradient (tests/test_pallas_conv.py's
tiny-UNet bound).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.models import unet as junet  # noqa: E402
from cgd_tpu.registry import DIFFUSION_LOOKUP  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.models import unet as tunet  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-3, rtol=1e-3)


def _tiny_cfgs(class_cond, scale_shift=True):
    kw = dict(image_size=32, model_channels=32, num_res_blocks=1, attention_ds=(2,),
              channel_mult=(1, 2), num_head_channels=16,
              num_classes=7 if class_cond else None, use_scale_shift_norm=scale_shift)
    return junet.UNetConfig(**kw), tunet.UNetConfig(**kw)


def _perturbed_params(cfg, seed):
    params = junet.init_unet(jax.random.PRNGKey(seed), cfg)
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [jnp.asarray(np.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32))
                  for l in leaves])


@pytest.mark.parametrize("class_cond,scale_shift", [(True, True), (False, True), (True, False)])
def test_unet_forward_and_input_gradient_match_jax(class_cond, scale_shift):
    jcfg, tcfg = _tiny_cfgs(class_cond, scale_shift)
    params = _perturbed_params(jcfg, 0)
    model = load_from_jax(tunet.UNet(tcfg), params)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    t = np.array([10.0, 700.0], np.float32)
    y = np.array([1, 5]) if class_cond else None
    probe = rs.randn(2, 32, 32, 6).astype(np.float32)

    def jloss(x_):
        out = junet.apply_unet(params, jcfg, x_, jnp.asarray(t),
                               None if y is None else jnp.asarray(y))
        return jnp.sum(jnp.sin(out) * probe), out

    (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(t), None if y is None else torch.from_numpy(y))
    (torch.sin(out) * torch.from_numpy(probe)).sum().backward()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), **TOL)


def test_plain_routing_matches_kernel_routing():
    """kernel_routing("plain") (unfused F.conv2d chain) and the default
    kernel route compute the same UNet."""
    from cgd_tpu_torch.ops.nn import kernel_routing

    jcfg, tcfg = _tiny_cfgs(True)
    model = load_from_jax(tunet.UNet(tcfg), _perturbed_params(jcfg, 2))
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 32, 32, 3).astype(np.float32))
    t, y = torch.tensor([50.0]), torch.tensor([2])
    with torch.no_grad():
        fused = model(x, t, y)
        with kernel_routing("plain"):
            plain = model(x, t, y)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), **TOL)


def test_the_f32_unet_calls_the_fused_functions_as_the_bf16_one_does(monkeypatch):
    """At compute_dtype float32 the kernel route reaches exactly the fused
    autograd Functions the bf16 UNet reaches (conv3x3, conv3x3_gn_silu, _add,
    _up and the attention), as often, with f32 operands: on a card each
    is an f32 kernel (K-fwd f32's modes, K-dx f32, K-attn f32), here its
    plain version. The toy tree has down and up ResBlocks and attention."""
    from cgd_tpu_torch.kernels import attention as kattn
    from cgd_tpu_torch.kernels import conv3x3 as k3

    calls = []
    for mod, name in ((k3, "conv3x3"), (k3, "conv3x3_gn_silu"), (k3, "conv3x3_gn_silu_add"),
                      (k3, "conv3x3_gn_silu_up"), (kattn, "qkv_attention")):
        real = getattr(mod, name)

        def counted(x, *args, _real=real, _name=name):
            calls.append((_name, x.dtype))
            return _real(x, *args)

        monkeypatch.setattr(mod, name, counted)
    jcfg, tcfg = _tiny_cfgs(True)
    model = load_from_jax(tunet.UNet(tcfg), _perturbed_params(jcfg, 4))
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32))
    t, y = torch.tensor([80.0]), torch.tensor([3])
    counts = {}
    for dtype in (torch.bfloat16, torch.float32):
        calls.clear()
        xt = x.clone().requires_grad_(True)
        out = model(xt, t, y, compute_dtype=dtype)
        out.float().sum().backward()
        assert {dt for _, dt in calls} == {dtype} and torch.isfinite(xt.grad).all()
        counts[dtype] = {n: sum(1 for m, _ in calls if m == n) for n, _ in calls}
    assert counts[torch.float32] == counts[torch.bfloat16]
    assert set(counts[torch.float32]) == {"conv3x3", "conv3x3_gn_silu", "conv3x3_gn_silu_add",
                                          "conv3x3_gn_silu_up", "qkv_attention"}


def test_random_init_statistics_follow_jax_init():
    """The port's own random init: zero out_convs and projections (the
    model outputs exactly 0, as the JAX init does), unit norms, and the
    same uniform bounds."""
    _, tcfg = _tiny_cfgs(True)
    model = tunet.UNet(tcfg).init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert float(sd["out_conv.kernel"].abs().max()) == 0.0
    assert float(sd["middle.1.proj.kernel"].abs().max()) == 0.0
    assert torch.equal(sd["out_norm.scale"], torch.ones_like(sd["out_norm.scale"]))
    bound = 1.0 / np.sqrt(9 * 3)
    k = sd["conv_in.kernel"]
    assert float(k.abs().max()) <= bound and float(k.abs().max()) > 0.5 * bound
    out = model(torch.randn(1, 32, 32, 3), torch.tensor([3.0]), torch.tensor([0]))
    assert float(out.abs().max()) == 0.0


def test_full_256px_parameter_tree_matches_jax():
    """At the full 256px class-conditional config the port's parameter
    paths and shapes are exactly the JAX pytree's (no compute: jax.eval_shape
    on one side, the meta device on the other)."""
    flags = DIFFUSION_LOOKUP["cond"][256]["model_flags"]
    jcfg = junet.UNetConfig.from_flags(flags)
    tcfg = tunet.UNetConfig.from_flags(flags)
    assert tunet.block_plan(tcfg) == junet.block_plan(jcfg)
    shapes = jax.eval_shape(lambda: junet.init_unet(jax.random.PRNGKey(0), jcfg))
    jshapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        jshapes[key] = tuple(leaf.shape)
    model = tunet.UNet(tcfg, device="meta")
    tshapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert tshapes == jshapes
    assert sum(np.prod(s) for s in tshapes.values()) > 500e6


def test_full_128px_parameter_tree_matches_jax():
    """The 128px model, the API's and the CLI's default size: num_heads=4
    at every attention (head dims 128 / 192 / 256 at 32^2 / 16^2 / 8^2).
    Its block plan, parameter paths and shapes are the JAX pytree's."""
    flags = DIFFUSION_LOOKUP["cond"][128]["model_flags"]
    jcfg = junet.UNetConfig.from_flags(flags)
    tcfg = tunet.UNetConfig.from_flags(flags)
    assert (tcfg.num_heads, tcfg.num_head_channels) == (jcfg.num_heads, jcfg.num_head_channels)
    assert tcfg.num_heads == 4 and tcfg.num_head_channels == -1
    assert tunet.block_plan(tcfg) == junet.block_plan(jcfg)
    shapes = jax.eval_shape(lambda: junet.init_unet(jax.random.PRNGKey(0), jcfg))
    jshapes = {
        ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    model = tunet.UNet(tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == jshapes
    heads = {m.heads for m in model.modules() if isinstance(m, tunet.AttentionBlock)}
    assert heads == {4}


def test_num_heads_unet_matches_jax():
    """A tiny UNet in the 128px model's flag style (num_heads=4,
    num_head_channels=-1: the head dim is the level's channels / 4 and
    grows with depth, 16 then 24 here), forward and input gradient against
    apply_unet on the same weights (the toy configs elsewhere fix the head
    dim with num_head_channels)."""
    kw = dict(image_size=32, model_channels=32, num_res_blocks=1, attention_ds=(2, 4),
              channel_mult=(1, 2, 3), num_heads=4, num_head_channels=-1, num_classes=7)
    jcfg, tcfg = junet.UNetConfig(**kw), tunet.UNetConfig(**kw)
    params = _perturbed_params(jcfg, 8)
    model = load_from_jax(tunet.UNet(tcfg), params)
    dims = sorted({m.qkv.kernel.shape[0] // m.heads for m in model.modules()
                   if isinstance(m, tunet.AttentionBlock)})
    assert dims == [16, 24]
    rs = np.random.RandomState(9)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    t, y = np.array([20.0, 600.0], np.float32), np.array([1, 6])
    probe = rs.randn(2, 32, 32, 6).astype(np.float32)

    def jloss(x_):
        out = junet.apply_unet(params, jcfg, x_, jnp.asarray(t), jnp.asarray(y))
        return jnp.sum(jnp.sin(out) * probe), out

    (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(t), torch.from_numpy(y))
    (torch.sin(out) * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), **TOL)


@pytest.mark.parametrize("cond", ["cond", "uncond"])
def test_full_512px_parameter_trees_match_jax(cond):
    """The 512px operating point (7 levels, channel_mult (0.5, 1, 1, 2, 2,
    4, 4)): the port's block plan, parameter paths and shapes are the JAX
    pytree's."""
    flags = DIFFUSION_LOOKUP[cond][512]["model_flags"]
    jcfg = junet.UNetConfig.from_flags(flags)
    tcfg = tunet.UNetConfig.from_flags(flags)
    assert tcfg.channel_mult == jcfg.channel_mult == (0.5, 1, 1, 2, 2, 4, 4)
    assert tunet.block_plan(tcfg) == junet.block_plan(jcfg)
    shapes = jax.eval_shape(lambda: junet.init_unet(jax.random.PRNGKey(0), jcfg))
    jshapes = {
        ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    model = tunet.UNet(tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == jshapes
    assert jshapes["conv_in.kernel"] == (3, 3, 3, 128)
    assert ("label_emb.table" in jshapes) == (cond == "cond")


def test_fractional_channel_mult_unet_matches_jax():
    """A tiny UNet with the 512px model's fractional first multiplier
    (channel_mult (0.5, 1, 2): 16 channels at full resolution), forward and
    input gradient against apply_unet."""
    kw = dict(image_size=32, model_channels=32, num_res_blocks=1, attention_ds=(2, 4),
              channel_mult=(0.5, 1, 2), num_head_channels=16, num_classes=7)
    jcfg, tcfg = junet.UNetConfig(**kw), tunet.UNetConfig(**kw)
    params = _perturbed_params(jcfg, 4)
    model = load_from_jax(tunet.UNet(tcfg), params)
    assert model.conv_in.kernel.shape == (3, 3, 3, 16)
    rs = np.random.RandomState(6)
    x = rs.randn(1, 32, 32, 3).astype(np.float32)
    t, y = np.array([400.0], np.float32), np.array([3])
    probe = rs.randn(1, 32, 32, 6).astype(np.float32)

    def jloss(x_):
        out = junet.apply_unet(params, jcfg, x_, jnp.asarray(t), jnp.asarray(y))
        return jnp.sum(jnp.sin(out) * probe), out

    (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(t), torch.from_numpy(y))
    (torch.sin(out) * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), **TOL)
