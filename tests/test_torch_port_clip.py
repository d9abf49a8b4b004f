"""The port's CLIP towers (ViT, ModifiedResNet, text) against
cgd_tpu.models.clip on the same weights, in f32 on the CPU (tolerance atol
2e-4 / rtol 2e-4, the bound tests/test_torch_crosscheck.py holds the JAX
towers to), plus the copied configuration table pinned to the original."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=2e-4)


def _tiny(res=64, patch=16):
    cfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["ViT-B/32"],
        vision=jconfigs.VisionViTConfig(res, patch, 64, 2, 2),
        text=jconfigs.TextConfig(context_length=16, vocab_size=100, width=32, heads=2, layers=2),
        embed_dim=24,
    )
    tcfg = tconfigs.CLIPConfig(
        cfg.name, cfg.embed_dim,
        tconfigs.VisionViTConfig(*dataclasses.astuple(cfg.vision)),
        tconfigs.TextConfig(*dataclasses.astuple(cfg.text)),
    )
    params = jclip.init_clip(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(0)  # perturb the unit norms / zero biases too
    params = jax.tree.unflatten(
        treedef, [jnp.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32) for l in leaves])
    return cfg, params, load_from_jax(tclip.CLIP(tcfg), params)


def test_config_table_copy_matches_original():
    assert set(tconfigs.CLIP_CONFIGS) == set(jconfigs.CLIP_CONFIGS)
    for name, cfg in jconfigs.CLIP_CONFIGS.items():
        assert dataclasses.asdict(tconfigs.CLIP_CONFIGS[name]) == dataclasses.asdict(cfg), name
        assert tconfigs.CLIP_CONFIGS[name].is_vit == cfg.is_vit
    assert tconfigs.CLIP_MEAN == jconfigs.CLIP_MEAN and tconfigs.CLIP_STD == jconfigs.CLIP_STD


def test_encode_image_matches_jax():
    cfg, params, model = _tiny()
    x = np.random.RandomState(1).randn(3, 64, 64, 3).astype(np.float32)
    ref = jclip.encode_image(params, cfg, jnp.asarray(x))
    with torch.no_grad():
        ours = tclip.encode_image(model, torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_encode_image_gradient_matches_jax():
    """The guidance gradient flows back through the ViT into the cutouts."""
    cfg, params, model = _tiny()
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    gref = jax.grad(lambda v: jnp.sum(jnp.sin(jclip.encode_image(params, cfg, v))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sin(tclip.encode_image(model, xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), atol=5e-4, rtol=1e-3)


def test_encode_text_matches_jax():
    cfg, params, model = _tiny()
    tokens = np.zeros((2, 16), np.int32)
    tokens[0, :5] = [98, 5, 17, 3, 99]
    tokens[1, :3] = [98, 42, 99]
    ref = jclip.encode_text(params, cfg, jnp.asarray(tokens))
    with torch.no_grad():
        ours = tclip.encode_text(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_full_vit_b32_parameter_tree_matches_jax():
    cfg = jconfigs.CLIP_CONFIGS["ViT-B/32"]
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0), cfg))
    jshapes = {
        ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    model = tclip.CLIP(tconfigs.CLIP_CONFIGS["ViT-B/32"], device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == jshapes


def _tiny_rn(res=64):
    """A tiny ModifiedResNet (width 8, one bottleneck per stage)."""
    cfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["RN50x16"],
        vision=jconfigs.VisionResNetConfig(res, 8, (1, 1, 1, 1), 4),
        text=jconfigs.TextConfig(context_length=16, vocab_size=100, width=32, heads=2, layers=1),
        embed_dim=24,
    )
    tcfg = tconfigs.CLIPConfig(
        cfg.name, cfg.embed_dim,
        tconfigs.VisionResNetConfig(*dataclasses.astuple(cfg.vision)),
        tconfigs.TextConfig(*dataclasses.astuple(cfg.text)),
    )
    params = jclip.init_clip(jax.random.PRNGKey(3), cfg)
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(3)  # perturb the unit BN scales / zero biases too
    params = jax.tree.unflatten(
        treedef, [jnp.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32) for l in leaves])
    return cfg, params, load_from_jax(tclip.CLIP(tcfg), params)


def test_resnet_encode_image_matches_jax():
    cfg, params, model = _tiny_rn()
    x = np.random.RandomState(4).randn(3, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda p, v: jclip.encode_image(p, cfg, v))(params, jnp.asarray(x))
    with torch.no_grad():
        ours = tclip.encode_image(model, torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_resnet_encode_image_gradient_matches_jax():
    """The guidance gradient flows back through the ResNet into the cutouts."""
    cfg, params, model = _tiny_rn()
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    gref = jax.jit(jax.grad(lambda v: jnp.sum(jnp.sin(jclip.encode_image(params, cfg, v)))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sin(tclip.encode_image(model, xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("name", ["RN50", "RN50x16"])
def test_full_resnet_parameter_tree_matches_jax(name):
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0), jconfigs.CLIP_CONFIGS[name]))
    jshapes = {
        ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    model = tclip.CLIP(tconfigs.CLIP_CONFIGS[name], device="meta")
    tshapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert tshapes == jshapes
    assert "visual.layer3.5.conv2.kernel" in tshapes and "visual.attnpool.q_proj.kernel" in tshapes


def test_resnet_random_init_follows_jax_init():
    """Unit folded BN, conv kernels uniform in +-1/sqrt(fan_in), the
    attnpool's positional embedding with std 1/sqrt(C)."""
    _, _, model = _tiny_rn()
    model.init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert torch.equal(sd["visual.bn1.scale"], torch.ones(4))
    assert float(sd["visual.layer1.0.bn3.bias"].abs().max()) == 0.0
    k = sd["visual.conv2.kernel"]
    bound = 1.0 / np.sqrt(9 * 4)
    assert 0.5 * bound < float(k.abs().max()) <= bound
    pe = sd["visual.attnpool.positional_embedding"]
    assert abs(float(pe.std()) * np.sqrt(256) - 1.0) < 0.2


def test_resnet_tower_raises():
    """The ResNet tower takes its configured input resolution only: the
    attnpool's positional embedding does not fit another grid."""
    _, _, model = _tiny_rn()
    with pytest.raises(RuntimeError):
        tclip.encode_image(model, torch.zeros(1, 96, 96, 3))


def test_debug_tiny_swaps_every_tower_for_a_tiny_vit(monkeypatch):
    """CGD_TPU_DEBUG_TINY as cgd_tpu.weights has it: a ResNet name gives
    the same tiny ViT configuration on both sides."""
    from cgd_tpu import weights as jweights
    from cgd_tpu_torch import weights as tweights

    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    _, jcfg = jweights.resolve_clip("RN50x16", mode="random")
    model, tcfg = tweights.resolve_clip("RN50x16", "random", "cpu")
    assert tcfg.is_vit and dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert isinstance(model.visual, tclip.ViT)
