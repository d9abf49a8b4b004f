"""The model cache (``cgd_tpu_torch/weights.py``) on a card: the 256px
unconditional ADM with CLIP ViT-B/32 from seeded file-backed weights (the
port's own ``.npz.cgd`` caches, float16, as the benchmark writes them),
called twice in one process. The second call serves both models from the
cache and its predictions and frames are bit-equal to the first's (the
path is bit-reproducible on the card). A float32 call after a bfloat16 one
loads both models anew and launches no bfloat16 conv kernel.

Marked ``cuda``; imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_model_cache_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

MERGES = ["t h", "th e</w>", "l i", "li g", "lig h", "ligh t", "h o", "ho u", "hou s", "hous e</w>"]


def _write_caches(ckpts, dev) -> None:
    """Seeded 256px unconditional UNet (its zero-init layers drawn too, so
    that its output is not 0) and ViT-B/32, saved as float16 ``.npz.cgd``
    caches under the registry's names."""
    from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS
    from cgd_tpu_torch.models.clip.model import CLIP
    from cgd_tpu_torch.models.unet import Conv, Dense, UNet, UNetConfig
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP
    from cgd_tpu_torch.utils import pytree_io

    gen = torch.Generator(dev).manual_seed(21)
    info = DIFFUSION_LOOKUP["uncond"][256]
    unet = UNet(UNetConfig.from_flags(info["model_flags"]), device=dev).init_weights(gen)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, (Conv, Dense)) and m.zero:
                bound = 1.0 / float(np.prod(m.kernel.shape[:-1])) ** 0.5
                m.kernel.uniform_(-bound, bound, generator=gen)
    clip = CLIP(CLIP_CONFIGS["ViT-B/32"], device=dev).init_weights(gen)
    (ckpts / "clip").mkdir(parents=True)
    for module, path in ((unet, ckpts / (info["filename"] + ".npz.cgd")),
                         (clip, ckpts / "clip" / "ViT-B-32.pt.npz.cgd")):
        pytree_io.save_flat(str(path), {k: v.detach().cpu().numpy().astype(np.float16)
                                        for k, v in module.state_dict().items()})


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ckpts(dev, tmp_path_factory):
    path = tmp_path_factory.mktemp("model_cache") / "ckpts"
    _write_caches(path, dev)
    return path


@pytest.fixture
def api_call(ckpts, dev, tmp_path, monkeypatch):
    """(call, preds): call(run, **kw) runs the API on the cached files into
    ``tmp_path / run`` and returns its frames' bytes; preds collects each
    yielded step's predicted x0. The tokenizer is a tiny merge table's;
    the model cache starts and ends empty."""
    from cgd_tpu_torch import api
    from cgd_tpu_torch import weights as tweights
    from cgd_tpu_torch.models.clip import tokenizer

    merges = tmp_path / "merges.txt"
    merges.write_text("#version: tiny\n" + "\n".join(MERGES) + "\n")
    monkeypatch.setattr(tokenizer, "_DEFAULT_TOKENIZER",
                        tokenizer.SimpleTokenizer(str(merges), 256 + 2 + len(MERGES)))
    monkeypatch.chdir(tmp_path)  # the API writes current.png beside its frames
    preds = []
    real = api.sample_loop

    def spy(*a, **kw):
        for item in real(*a, **kw):
            preds.append(item[1].detach().clone())
            yield item

    monkeypatch.setattr(api, "sample_loop", spy)

    def call(run, **kw):
        args = dict(prompts=["the lighthouse"], image_size=256, class_cond=False,
                    clip_model_name="ViT-B/32", timestep_respacing="ddim10", num_cutouts=16,
                    save_frequency=3, seed=5, weights_mode="auto", checkpoints_dir=str(ckpts),
                    device=str(dev), progress=False, prefix_path=str(tmp_path / run))
        args.update(kw)
        return [open(p, "rb").read() for _, p in api.clip_guided_diffusion(**args)]

    tweights.clear_model_cache()
    yield call, preds
    tweights.clear_model_cache()


def _delta(before):
    from cgd_tpu_torch import weights as tweights

    now = tweights.cache_stats()
    return {k: now[k] - before[k] for k in now}


def test_a_second_256px_call_hits_both_models_and_gives_bit_equal_frames(api_call):
    from cgd_tpu_torch import weights as tweights

    call, preds = api_call
    before = tweights.cache_stats()
    first = call("a")
    assert _delta(before) == {"hits": 0, "misses": 2}
    n = len(preds)
    second = call("b")
    assert _delta(before) == {"hits": 2, "misses": 2}
    assert n == 4 and len(preds) == 2 * n  # steps 0, 3, 6, 9
    for a, b in zip(preds[:n], preds[n:]):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert first == second and len(first) == n


def test_a_float32_call_after_a_bfloat16_one_launches_no_bfloat16_conv(api_call):
    from cgd_tpu_torch import weights as tweights
    from cgd_tpu_torch.kernels import conv3x3 as k3

    call, _ = api_call
    call("bf16", timestep_respacing="ddim4", save_frequency=4)
    before = tweights.cache_stats()
    k3.reset_launch_counts()
    frames = call("f32", timestep_respacing="ddim4", save_frequency=4, compute_dtype="float32")
    launches = dict(k3.LAUNCHES)
    assert _delta(before) == {"hits": 0, "misses": 2}
    assert len(frames) == 2  # steps 0 and 3
    assert launches["conv3x3_fwd"] == launches["conv3x3_dx"] == 0, launches
    assert launches["conv3x3_fwd_f32"] > 0 and launches["conv3x3_dx_f32"] > 0, launches
