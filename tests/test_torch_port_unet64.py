"""The 64px model of the port against cgd_tpu.models.unet: its full
parameter tree (no compute), and a narrowed UNet in its style, forward and
input gradient on the same weights in f32 on the CPU, at
tests/test_torch_port_unet.py's tolerance (atol and rtol 1e-3). A file of
its own so that neither file's run passes about a minute.
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
from tests.test_torch_port_unet import TOL, _perturbed_params  # noqa: E402

torch.set_num_threads(2)


def test_full_64px_parameter_tree_matches_jax():
    """The 64px model (registry.py:46-50: 192 channels, channel_mult (1, 2,
    3, 4), 3 res blocks, the cosine schedule and the new attention order):
    its block plan, parameter paths and shapes are the JAX pytree's, and its
    attention runs 6 / 9 / 12 heads of d = 64 at 32^2 / 16^2 / 8^2."""
    flags = DIFFUSION_LOOKUP["cond"][64]["model_flags"]
    jcfg = junet.UNetConfig.from_flags(flags)
    tcfg = tunet.UNetConfig.from_flags(flags)
    assert tcfg == tunet.UNetConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    assert (tcfg.model_channels, tcfg.channel_mult, tcfg.num_res_blocks) == (192, (1, 2, 3, 4), 3)
    assert tcfg.use_new_attention_order and tcfg.attention_ds == (2, 4, 8)
    assert tunet.block_plan(tcfg) == junet.block_plan(jcfg)
    shapes = jax.eval_shape(lambda: junet.init_unet(jax.random.PRNGKey(0), jcfg))
    jshapes = {
        ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    model = tunet.UNet(tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == jshapes
    heads = sorted((m.heads, m.qkv.kernel.shape[0] // m.heads) for m in model.modules()
                   if isinstance(m, tunet.AttentionBlock))
    assert sorted(set(heads)) == [(6, 64), (9, 64), (12, 64)]
    convs = {tuple(v.shape) for k, v in model.state_dict().items()
             if v.dim() == 4 and v.shape[:2] == (3, 3)}
    assert {(3, 3, 3, 192), (3, 3, 192, 192), (3, 3, 576, 576), (3, 3, 768, 768),
            (3, 3, 192, 6)} <= convs


def test_64px_style_unet_matches_jax():
    """A narrowed UNet in the 64px model's style (channel_mult (1, 2, 3, 4),
    3 res blocks, the new attention order, num_head_channels fixed: 2, 3 and
    4 heads at 16^2 / 8^2 / 4^2), forward and input gradient against
    apply_unet on the same weights."""
    kw = dict(image_size=32, model_channels=16, num_res_blocks=3, attention_ds=(2, 4, 8),
              channel_mult=(1, 2, 3, 4), num_head_channels=16, num_classes=7,
              use_new_attention_order=True)
    jcfg, tcfg = junet.UNetConfig(**kw), tunet.UNetConfig(**kw)
    params = _perturbed_params(jcfg, 10)
    model = load_from_jax(tunet.UNet(tcfg), params)
    assert sorted({m.heads for m in model.modules() if isinstance(m, tunet.AttentionBlock)}) == [
        2, 3, 4]
    rs = np.random.RandomState(11)
    x = rs.randn(1, 32, 32, 3).astype(np.float32)
    t, y = np.array([300.0], np.float32), np.array([2])
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
