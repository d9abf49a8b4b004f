"""The port's model cache (``cgd_tpu_torch/weights.py``) on the CPU: the toy
reference-layout checkpoints of tests/torch_port_toy_checkpoints.py
(``weights_mode="auto"``), 64px, ddim3, two cutouts.

- A second API call with the same files hits both models: the ``api.models``
  span's counts and ``cache_stats()`` say so, and it opens no ``weights.*``
  span. Its predictions are bit-equal to the same call's after
  ``clear_model_cache()``, and the kept parameters to a fresh load's, with
  no ``.grad``.
- A rewritten ``.npz.cgd``, another configuration or another conv dtype
  misses: a float32 call after a bfloat16 one loads anew and runs float32
  convs, as a fresh float32 call does.
- The Cog predictor's ``setup()`` fills the cache that ``predict()`` hits,
  at the predictor's compute dtype; two threads resolving one key load once,
  and a load of one role holds back no other role's hit; the LPIPS VGG and a
  local CLIP ``.pt`` are kept too; random weights never are.
"""

import os
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch import api  # noqa: E402
from cgd_tpu_torch import cog_predict  # noqa: E402
from cgd_tpu_torch import weights as tweights  # noqa: E402
from cgd_tpu_torch.utils import pytree_io, tracing  # noqa: E402
from tests import torch_port_toy_checkpoints as toy  # noqa: E402
from tests.torch_port_toy_checkpoints import no_kept_models  # noqa: E402,F401

torch.set_num_threads(2)

KW = dict(prompts=["the hello"], image_size=64, class_cond=True, num_cutouts=2,
          timestep_respacing="ddim3", save_frequency=1, weights_mode="auto", device="cpu",
          progress=False)
UNET_NPZ = "toy_unet.pt.npz.cgd"


@pytest.fixture
def ckpts(monkeypatch, tmp_path):
    """The toy checkpoints, converted to their ``.npz.cgd`` caches; nothing
    kept."""
    monkeypatch.chdir(tmp_path)  # the API writes current.png beside its frames
    path = tmp_path / "ckpts"
    toy.install(monkeypatch, tmp_path, path)
    tweights.resolve_unet(64, True, "auto", device="cpu", checkpoints_dir=str(path))
    tweights.resolve_clip("ViT-B/32", "auto", "cpu", str(path))
    tweights.clear_model_cache()
    return path


@pytest.fixture
def preds(monkeypatch):
    """The predicted x0 at each yielded step of every call, on the host."""
    seen = []
    real = api.sample_loop

    def spy(*a, **kw):
        for item in real(*a, **kw):
            seen.append(item[1].detach().float().cpu().clone())
            yield item

    monkeypatch.setattr(api, "sample_loop", spy)
    return seen


def _call(ckpts, out, **kw) -> list:
    """One API call's frames, as bytes."""
    args = dict(KW, checkpoints_dir=str(ckpts), prefix_path=str(out), **kw)
    return [open(p, "rb").read() for _, p in api.clip_guided_diffusion(**args)]


def _delta(before):
    now = tweights.cache_stats()
    return {k: now[k] - before[k] for k in now}


def _equal_state(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def _conv_dtypes(module) -> set:
    return {m.kernel.dtype for m in module.modules()
            if isinstance(getattr(m, "kernel", None), torch.Tensor) and m.kernel.dim() == 4}


def test_a_second_call_hits_both_models_and_opens_no_weights_span(ckpts, tmp_path):
    tracing.take()
    tracing.enable()
    try:
        before = tweights.cache_stats()
        _call(ckpts, tmp_path / "a")
        first = tracing.take()
        assert _delta(before) == {"hits": 0, "misses": 2}
        _call(ckpts, tmp_path / "b")
        second = tracing.take()
    finally:
        tracing.disable()
        tracing.take()
    assert _delta(before) == {"hits": 2, "misses": 2}
    (models,) = [s for s in first if s.name == "api.models"]
    assert models.counts == {"hits": 0, "misses": 2}
    assert sorted(s.name for s in first if s.name.startswith("weights.")) == sorted(
        ["weights.read", "weights.build", "weights.load", "weights.to_device"] * 2)
    (models,) = [s for s in second if s.name == "api.models"]
    assert models.counts == {"hits": 2, "misses": 0}
    assert not [s for s in second if s.name.startswith("weights.")]


def test_a_hit_predicts_bit_equal_to_a_fresh_load(ckpts, tmp_path, preds):
    _call(ckpts, tmp_path / "a")
    before = tweights.cache_stats()
    hit = _call(ckpts, tmp_path / "b")
    assert _delta(before) == {"hits": 2, "misses": 0}
    n = len(preds)
    tweights.clear_model_cache()
    fresh = _call(ckpts, tmp_path / "c")
    assert _delta(before) == {"hits": 2, "misses": 2}
    assert n == 6 and len(preds) == 9
    assert all(torch.equal(a, b) for a, b in zip(preds[n - 3:n], preds[n:]))
    assert hit == fresh


@pytest.mark.parametrize("role", ["unet", "clip"])
def test_the_kept_parameters_equal_a_fresh_load_and_carry_no_grad(ckpts, tmp_path, role):
    _call(ckpts, tmp_path / "a")

    def resolve():
        if role == "unet":
            return tweights.resolve_unet(64, True, "auto", device="cpu", checkpoints_dir=str(ckpts),
                                         conv_dtype=torch.bfloat16)[0]
        return tweights.resolve_clip("ViT-B/32", "auto", "cpu", str(ckpts),
                                     conv_dtype=torch.bfloat16)[0]

    before = tweights.cache_stats()
    kept = resolve()
    assert _delta(before) == {"hits": 1, "misses": 0}
    assert resolve() is kept
    tweights.clear_model_cache()
    fresh = resolve()
    assert fresh is not kept and _equal_state(kept, fresh)
    assert all(p.grad is None and not p.requires_grad for p in kept.parameters())
    assert _conv_dtypes(kept) == {torch.bfloat16}


def test_a_rewritten_cache_misses_and_loads_the_new_weights(ckpts, tmp_path, preds):
    first = _call(ckpts, tmp_path / "a")
    path = str(ckpts / UNET_NPZ)
    flat = pytree_io.load_flat(path)
    size = os.path.getsize(path)
    time.sleep(0.02)  # a later modification time than the file's first
    pytree_io.save_flat(path, {k: (v * 1.5 if k.endswith("kernel") else v)
                               for k, v in flat.items()})
    assert os.path.getsize(path) == size  # the same shapes: only the time tells them apart
    before = tweights.cache_stats()
    second = _call(ckpts, tmp_path / "b")
    assert _delta(before) == {"hits": 1, "misses": 1}  # the CLIP is the same
    assert second != first
    n = len(preds)
    tweights.clear_model_cache()
    assert _call(ckpts, tmp_path / "c") == second
    assert all(torch.equal(a, b) for a, b in zip(preds[n - 3:n], preds[n:]))
    unet = tweights.resolve_unet(64, True, "auto", device="cpu", checkpoints_dir=str(ckpts),
                                 conv_dtype=torch.bfloat16)[0]
    want = flat["conv_in.kernel"] * 1.5
    got = unet.state_dict()["conv_in.kernel"]
    assert torch.equal(got, torch.from_numpy(want).to(got.dtype))


def test_a_float32_call_after_a_bfloat16_one_loads_float32_convs(ckpts, tmp_path, preds):
    _call(ckpts, tmp_path / "bf16")
    before = tweights.cache_stats()
    f32 = _call(ckpts, tmp_path / "a", compute_dtype="float32")
    assert _delta(before) == {"hits": 0, "misses": 2}
    n = len(preds)
    for resolve in (lambda: tweights.resolve_unet(64, True, "auto", device="cpu",
                                                  checkpoints_dir=str(ckpts))[0],
                    lambda: tweights.resolve_clip("ViT-B/32", "auto", "cpu", str(ckpts))[0]):
        assert _conv_dtypes(resolve()) == {torch.float32}
    assert _delta(before) == {"hits": 2, "misses": 2}  # the float32 models are the kept ones
    tweights.clear_model_cache()
    assert _call(ckpts, tmp_path / "b", compute_dtype="float32") == f32
    assert all(torch.equal(a, b) for a, b in zip(preds[n - 3:n], preds[n:]))


def test_another_configuration_or_checkpoints_dir_misses(ckpts, tmp_path):
    unet = tweights.resolve_unet(64, True, "auto", device="cpu", checkpoints_dir=str(ckpts))[0]
    before = tweights.cache_stats()
    other, cfg, _ = tweights.resolve_unet(64, True, "auto", flag_overrides={"dropout": 0.1},
                                          device="cpu", checkpoints_dir=str(ckpts))
    assert cfg.dropout == 0.1 and other is not unet and _equal_state(other, unet)
    assert _delta(before) == {"hits": 0, "misses": 1}
    moved = tmp_path / "moved"
    moved.mkdir()
    os.replace(ckpts / UNET_NPZ, moved / UNET_NPZ)
    again = tweights.resolve_unet(64, True, "auto", flag_overrides={"dropout": 0.1},
                                  device="cpu", checkpoints_dir=str(moved))[0]
    assert again is not other and _equal_state(again, unet)
    assert _delta(before) == {"hits": 0, "misses": 2}


def _cog_predictor(ckpts, monkeypatch):
    """The predictor runs the 256px unconditional model; here the registry
    maps it to the toy 64px one, and predict()'s call is cut to 64px (the
    toy model at 256px attends over 128^2 tokens, minutes a step)."""
    entry = tweights.DIFFUSION_LOOKUP["cond"][64]
    monkeypatch.setitem(tweights.DIFFUSION_LOOKUP, "uncond", {256: entry})
    for name in ("resolve_unet", "resolve_clip"):  # setup()'s default checkpoints_dir
        real = getattr(tweights, name)
        monkeypatch.setattr(tweights, name, lambda *a, _r=real, **kw: _r(
            *a, **dict(kw, checkpoints_dir=str(ckpts))))
    real_api = api.clip_guided_diffusion
    monkeypatch.setattr(api, "clip_guided_diffusion", lambda **kw: real_api(
        **dict(kw, image_size=64, class_cond=True, checkpoints_dir=str(ckpts))))
    pred = cog_predict.ClipGuidedDiffusionPredictor()
    pred.device = "cpu"
    return pred


def test_the_cog_predictors_setup_fills_what_predict_hits(ckpts, monkeypatch):
    pred = _cog_predictor(ckpts, monkeypatch)
    before = tweights.cache_stats()
    pred.setup()
    assert _delta(before) == {"hits": 0, "misses": 2}
    frames = list(pred.predict(prompt="the hello", respace="ddim2", num_cutouts=2))
    assert [p.name for p in frames] == ["0000.png", "0001.png"]
    assert _delta(before) == {"hits": 2, "misses": 2}


def test_the_cog_predictors_setup_keeps_the_convs_of_its_compute_dtype(ckpts, monkeypatch):
    """A predictor set to float32 keeps float32 convs in setup(), and its
    predict() hits them."""
    pred = _cog_predictor(ckpts, monkeypatch)
    pred.compute_dtype = "float32"
    before = tweights.cache_stats()
    pred.setup()
    frames = list(pred.predict(prompt="the hello", respace="ddim2", num_cutouts=2))
    assert len(frames) == 2
    assert _delta(before) == {"hits": 2, "misses": 2}
    unet = tweights.resolve_unet(64, True, "auto", device="cpu", checkpoints_dir=str(ckpts))[0]
    assert _delta(before) == {"hits": 3, "misses": 2} and _conv_dtypes(unet) == {torch.float32}


def test_a_load_holds_back_no_other_roles_hit(ckpts, monkeypatch):
    """While one request loads a UNet, another's kept CLIP is served at
    once: a role's load waits only for that role's resolves."""
    clip = tweights.resolve_clip("ViT-B/32", "auto", "cpu", str(ckpts))[0]
    started, release = threading.Event(), threading.Event()
    real = tweights._on_device

    def held(*a, **kw):
        started.set()
        release.wait(timeout=60)
        return real(*a, **kw)

    monkeypatch.setattr(tweights, "_on_device", held)
    loader = threading.Thread(target=lambda: tweights.resolve_unet(
        64, True, "auto", device="cpu", checkpoints_dir=str(ckpts)))
    loader.start()
    try:
        assert started.wait(timeout=60)
        before = tweights.cache_stats()
        assert tweights.resolve_clip("ViT-B/32", "auto", "cpu", str(ckpts))[0] is clip
        assert not release.is_set() and loader.is_alive()  # the UNet still loading
        assert _delta(before) == {"hits": 1, "misses": 0}
    finally:
        release.set()
        loader.join(timeout=60)
    assert not loader.is_alive() and _delta(before) == {"hits": 1, "misses": 1}


def test_two_threads_resolving_one_key_load_once(ckpts, monkeypatch):
    """Two threads that miss together, then more threads than cores with a
    short switch interval: one load, one module, and counts that a lost
    update would break."""
    loads = []
    real = tweights._on_device

    def slow(*a, **kw):
        loads.append(threading.get_ident())
        time.sleep(0.2)  # the other threads ask meanwhile
        return real(*a, **kw)

    monkeypatch.setattr(tweights, "_on_device", slow)
    got, errors = [], []

    def resolve():
        try:
            got.append(tweights.resolve_unet(64, True, "auto", device="cpu",
                                             checkpoints_dir=str(ckpts))[0])
        except Exception as e:  # surfaced below
            errors.append(e)

    def race(n):
        threads = [threading.Thread(target=resolve) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    before = tweights.cache_stats()
    race(2)
    assert not errors and len(loads) == 1
    assert len(got) == 2 and got[0] is got[1]
    assert _delta(before) == {"hits": 1, "misses": 1}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        race(4 * (os.cpu_count() or 1))
    finally:
        sys.setswitchinterval(interval)
    n = 2 + 4 * (os.cpu_count() or 1)
    assert not errors and len(loads) == 1
    assert len(got) == n and all(m is got[0] for m in got)
    assert _delta(before) == {"hits": n - 1, "misses": 1}


@pytest.mark.parametrize("which", ["lpips", "local_clip"])
def test_the_lpips_vgg_and_a_local_clip_are_kept_too(ckpts, tmp_path, monkeypatch, which):
    if which == "lpips":
        toy.write_lpips_pth(tmp_path / "cache")
        monkeypatch.setattr(toy.tlpipsconv, "CACHE_PATH", str(tmp_path / "cache"))

        def resolve():
            return tweights.resolve_lpips("auto", "cpu", str(ckpts))
        touched = ckpts / "lpips_vgg.npz.cgd"
    else:
        touched = ckpts / "clip" / "ViT-B-32.pt"

        def resolve():
            return tweights.resolve_clip(str(touched), "auto", "cpu")[0]

    before = tweights.cache_stats()
    first = resolve()
    assert resolve() is first
    assert _delta(before) == {"hits": 1, "misses": 1}
    st = os.stat(touched)
    os.utime(touched, ns=(st.st_atime_ns, st.st_mtime_ns + 1))  # the file touched
    again = resolve()
    assert again is not first and _equal_state(again, first)
    assert _delta(before) == {"hits": 1, "misses": 2}


def test_random_weights_are_never_kept(monkeypatch):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    before = tweights.cache_stats()
    a = tweights.resolve_unet(64, True, "random", device="cpu", conv_dtype=torch.bfloat16)[0]
    b = tweights.resolve_unet(64, True, "random", device="cpu", conv_dtype=torch.bfloat16)[0]
    assert a is not b and _equal_state(a, b) and _conv_dtypes(a) == {torch.bfloat16}
    assert _delta(before) == {"hits": 0, "misses": 0}
