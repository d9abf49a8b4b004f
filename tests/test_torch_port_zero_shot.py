"""cgd_tpu_torch/zero_shot.py against cgd_tpu/zero_shot.py on the CPU: the
class list is the JAX package's (equal lists), and ``imagenet_top_n`` on a
tiny CLIP carried across by convert/from_jax.py (the JAX weights, perturbed
so that no norm or bias is trivial) ranks the classes as the JAX function
does: the same top 10, in the same order, for two queries."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu import zero_shot as jzs  # noqa: E402
from cgd_tpu.api import _FallbackTokenizer  # noqa: E402
from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu_torch import zero_shot as tzs  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402

torch.set_num_threads(2)


def test_the_class_list_is_the_jax_packages():
    assert tzs.imagenet_classes() == jzs.imagenet_classes()
    assert len(tzs.imagenet_classes()) == 1000


@pytest.mark.parametrize("seed", [0, 1])
def test_imagenet_top_n_ranks_as_cgd_tpu(seed):
    cfg = dataclasses.replace(
        jconfigs.CLIP_CONFIGS["ViT-B/32"],
        vision=jconfigs.VisionViTConfig(32, 16, 32, 1, 2),
        text=jconfigs.TextConfig(context_length=16, vocab_size=300, width=32, heads=2, layers=2),
        embed_dim=24,
    )
    tcfg = tconfigs.CLIPConfig(
        cfg.name, cfg.embed_dim,
        tconfigs.VisionViTConfig(*dataclasses.astuple(cfg.vision)),
        tconfigs.TextConfig(*dataclasses.astuple(cfg.text)),
    )
    params = jclip.init_clip(jax.random.PRNGKey(seed), cfg)
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(seed)
    params = jax.tree.unflatten(
        treedef, [jnp.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32) for l in leaves])
    model = load_from_jax(tclip.CLIP(tcfg), params)
    tokenizer = _FallbackTokenizer(300, 16)
    query = rs.randn(1, 24).astype(np.float32)
    want = jzs.imagenet_top_n(query, params, cfg, tokenizer, n=10)
    got = tzs.imagenet_top_n(query, model, tcfg, tokenizer, n=10)
    assert list(got) == list(want)
    assert len(tzs.imagenet_top_n(query, model, tcfg, tokenizer)) == 1000
