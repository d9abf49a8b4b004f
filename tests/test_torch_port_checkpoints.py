"""Checkpoint loading in the port against cgd_tpu, in f32 on the CPU.

The reference-layout state dicts come from the torch replicas of
tests/torch_ref_models.py (the published checkpoints' key names and
layouts): the ADM UNet with the legacy and the new attention order, the ViT
and text towers, the ModifiedResNet (BatchNorms folded), and a
torchvision-named VGG16 + lpips head pair. For each:
- the port's converter gives exactly the JAX converter's tree, flattened;
- the port's modules loaded from it match the torch replica's forward and
  cgd_tpu's, to 1e-4 relative (rtol 1e-4, atol 1e-4 x max |reference|: f32
  sums taken in other orders);
plus the copy of ``infer_clip_config`` and the flat npz format pinned to
their originals, the ``.npz.cgd`` cache written by either package loaded by the
other, the resolvers' ``auto`` mode on a temporary ``checkpoints_dir``, and
the downloader's copy (a ``file://`` URL, the retries, ``DownloadError``).
"""

import dataclasses
import os
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu import weights as jweights  # noqa: E402
from cgd_tpu.convert import clip_config_infer as jinfer  # noqa: E402
from cgd_tpu.convert import torch_clip as jclipconv  # noqa: E402
from cgd_tpu.convert import torch_unet as junetconv  # noqa: E402
from cgd_tpu.models import unet as junet  # noqa: E402
from cgd_tpu.models import vgg_lpips as jlpips  # noqa: E402
from cgd_tpu.models.clip import configs as jconfigs  # noqa: E402
from cgd_tpu.models.clip import model as jclip  # noqa: E402
from cgd_tpu.utils import pytree_io as jio  # noqa: E402
from cgd_tpu_torch import weights as tweights  # noqa: E402
from cgd_tpu_torch.convert import clip_config_infer as tinfer  # noqa: E402
from cgd_tpu_torch.convert import torch_clip as tclipconv  # noqa: E402
from cgd_tpu_torch.convert import torch_lpips as tlpipsconv  # noqa: E402
from cgd_tpu_torch.convert import torch_unet as tunetconv  # noqa: E402
from cgd_tpu_torch.convert.from_jax import flatten_pytree, load_flat  # noqa: E402
from cgd_tpu_torch.io_utils import download as tdownload  # noqa: E402
from cgd_tpu_torch.models import unet as tunet  # noqa: E402
from cgd_tpu_torch.models import vgg_lpips as tlpips  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import model as tclip  # noqa: E402
from cgd_tpu_torch.utils import pytree_io as tio  # noqa: E402
from tests import torch_port_toy_checkpoints as toy  # noqa: E402
from tests.torch_ref_models import (  # noqa: E402
    TorchADMUNet,
    TorchCLIPText,
    TorchCLIPViT,
    TorchModifiedResNet,
)

torch.set_num_threads(2)


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()), err_msg=what)


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _assert_flat_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def _unet_cfgs(**over):
    kw = dict(image_size=32, model_channels=32, num_res_blocks=1, attention_ds=(2, 4),
              channel_mult=(1, 2), num_head_channels=16, num_classes=7)
    kw.update(over)
    return junet.UNetConfig(**kw), tunet.UNetConfig(**kw)


def _torch_unet(jcfg, seed):
    torch.manual_seed(seed)
    tm = TorchADMUNet(jcfg).eval()
    with torch.no_grad():  # the replica's zero-init convs re-drawn, so every layer counts
        for p in tm.parameters():
            if not p.abs().sum():
                p.normal_(0, 0.05)
    return tm


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("new_order", [False, True], ids=["legacy_qkv", "new_qkv"])
def test_unet_converter_matches_jax_and_the_torch_reference(new_order):
    jcfg, tcfg = _unet_cfgs(use_new_attention_order=new_order)
    tm = _torch_unet(jcfg, 0)
    sd = _numpy(tm.adm_state_dict())
    jparams = junetconv.convert_state_dict(sd, jcfg)
    flat = tunetconv.convert_state_dict(sd, tcfg)
    _assert_flat_equal(flat, flatten_pytree(jparams))

    unet = load_flat(tunet.UNet(tcfg), flat)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    t = np.array([5.0, 700.0], np.float32)
    y = np.array([1, 4])
    with torch.no_grad():
        ours = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)).numpy()
        ref = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                 torch.from_numpy(y)).permute(0, 2, 3, 1).numpy()
    jout = junet.apply_unet(jparams, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    _close(ours, ref, "vs the torch reference")
    _close(ours, jout, "vs cgd_tpu")


def _clip_pair(seed=2, layers=2):
    torch.manual_seed(seed)
    vit = TorchCLIPViT(res=32, patch=8, width=64, layers=layers, heads=2, embed_dim=24).eval()
    txt = TorchCLIPText(vocab=96, ctx=12, width=48, heads=2, layers=2, embed_dim=24).eval()
    return vit, txt


def _clip_cfgs():
    jcfg = jconfigs.CLIPConfig("x", 24, jconfigs.VisionViTConfig(32, 8, 64, 2, 2),
                               jconfigs.TextConfig(12, 96, 48, 2, 2))
    tcfg = tconfigs.CLIPConfig("x", 24, tconfigs.VisionViTConfig(32, 8, 64, 2, 2),
                               tconfigs.TextConfig(12, 96, 48, 2, 2))
    return jcfg, tcfg


def _tokens():
    tokens = np.zeros((2, 12), np.int64)
    tokens[0, :3] = [94, 7, 95]
    tokens[1, :5] = [94, 3, 3, 3, 95]
    return tokens


def test_clip_vit_and_text_converter_matches_jax_and_the_torch_reference():
    vit, txt = _clip_pair()
    jcfg, tcfg = _clip_cfgs()
    sd = _numpy(vit.clip_state_dict(txt))
    jparams = jclipconv.convert_state_dict(sd, jcfg)
    flat = tclipconv.convert_state_dict(sd, tcfg)
    _assert_flat_equal(flat, flatten_pytree(jparams))

    model = load_flat(tclip.CLIP(tcfg), flat)
    imgs = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    tokens = _tokens()
    with torch.no_grad():
        ours_img = tclip.encode_image(model, torch.from_numpy(imgs)).numpy()
        ours_txt = tclip.encode_text(model, torch.from_numpy(tokens)).numpy()
        ref_img = vit(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
        ref_txt = txt(torch.from_numpy(tokens)).numpy()
    _close(ours_img, ref_img, "image vs torch")
    _close(ours_txt, ref_txt, "text vs torch")
    _close(ours_img, jclip.encode_image(jparams, jcfg, jnp.asarray(imgs)), "image vs cgd_tpu")
    _close(ours_txt, jclip.encode_text(jparams, jcfg, jnp.asarray(tokens.astype(np.int32))),
           "text vs cgd_tpu")


def _resnet_pair():
    torch.manual_seed(3)
    rn = TorchModifiedResNet((1, 1, 1, 1), 16, 64, 24, heads=8).eval()
    txt = TorchCLIPText(vocab=96, ctx=12, width=48, heads=2, layers=1, embed_dim=24).eval()
    with torch.no_grad():  # BN statistics away from 0 / 1, so the fold matters
        for m in rn.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.6, 1.4)
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
    return rn, txt


def test_clip_resnet_converter_folds_batchnorm_like_jax_and_the_torch_reference():
    rn, txt = _resnet_pair()
    jcfg = jconfigs.CLIPConfig("rn", 24, jconfigs.VisionResNetConfig(64, 16, (1, 1, 1, 1), 8),
                               jconfigs.TextConfig(12, 96, 48, 2, 1))
    tcfg = tconfigs.CLIPConfig("rn", 24, tconfigs.VisionResNetConfig(64, 16, (1, 1, 1, 1), 8),
                               tconfigs.TextConfig(12, 96, 48, 2, 1))
    sd = _numpy(rn.rn_state_dict(txt))
    jparams = jclipconv.convert_state_dict(sd, jcfg)
    flat = tclipconv.convert_state_dict(sd, tcfg)
    _assert_flat_equal(flat, flatten_pytree(jparams))
    bn = sd["visual.bn1.weight"] / np.sqrt(sd["visual.bn1.running_var"] + 1e-5)
    np.testing.assert_allclose(flat["visual.bn1.scale"], bn, rtol=1e-6)

    model = load_flat(tclip.CLIP(tcfg), flat)
    imgs = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        ours = tclip.encode_image(model, torch.from_numpy(imgs)).numpy()
        ref = rn(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
    _close(ours, ref, "vs torch")
    _close(ours, jclip.encode_image(jparams, jcfg, jnp.asarray(imgs)), "vs cgd_tpu")


def _lpips_pth(root):
    tm = toy.write_lpips_pth(root)
    return tm, str(root / "vgg16-397923af.pth"), str(root / "lpips_vgg_v0.1.pth")


def test_lpips_converter_matches_jax_and_the_torch_reference(tmp_path):
    from cgd_tpu.convert import torch_lpips as jlpipsconv

    tm, vgg_path, lin_path = _lpips_pth(tmp_path)
    jparams = jlpipsconv.convert_lpips(vgg_path, lin_path)
    flat = tlpipsconv.convert_lpips(vgg_path, lin_path)
    _assert_flat_equal(flat, flatten_pytree(jparams))

    model = load_flat(tlpips.VGGLPIPS(), flat)
    rs = np.random.RandomState(5)
    x = (rs.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    y = (rs.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    with torch.no_grad():
        ours = tlpips.lpips_distance(model, torch.from_numpy(x), torch.from_numpy(y)).numpy()
        ref = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(y).permute(0, 3, 1, 2)).numpy()
    _close(ours, ref, "vs torch")
    _close(ours, jlpips.lpips_distance(jparams, jnp.asarray(x), jnp.asarray(y)), "vs cgd_tpu")


@pytest.mark.parametrize("tower", ["vit", "resnet"])
def test_infer_clip_config_copy_matches_original(tower):
    if tower == "vit":
        vit, txt = _clip_pair()
        sd = _numpy(vit.clip_state_dict(txt))
    else:
        rn, txt = _resnet_pair()
        sd = _numpy(rn.rn_state_dict(txt))
    ours, ref = tinfer.infer_clip_config(sd, "m.pt"), jinfer.infer_clip_config(sd, "m.pt")
    assert type(ours.vision).__name__ == type(ref.vision).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


# ---------------------------------------------------------------------------
# the converted cache
# ---------------------------------------------------------------------------

def test_the_flat_npz_is_the_one_the_original_writes(tmp_path):
    tree = {"a": [np.arange(3, dtype=np.float32), {"k": np.ones((2, 2), np.float32)}],
            "b": np.float32(2.5)}
    jio.save_pytree(str(tmp_path / "j.npz.cgd"), tree)
    tio.save_flat(str(tmp_path / "t.npz.cgd"), flatten_pytree(tree))
    with np.load(tmp_path / "j.npz.cgd") as j, np.load(tmp_path / "t.npz.cgd") as t:
        assert j.files == t.files == ["a/0", "a/1/k", "b"]
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
    flat = tio.load_flat(str(tmp_path / "j.npz.cgd"))
    assert sorted(flat) == ["a.0", "a.1.k", "b"]
    np.testing.assert_array_equal(flat["a.1.k"], tree["a"][1]["k"])


def test_a_cache_written_by_either_package_loads_in_the_other(tmp_path):
    jcfg, tcfg = _unet_cfgs()
    jparams = jax.tree.map(np.asarray, junet.init_unet(jax.random.PRNGKey(3), jcfg))
    jio.save_pytree(str(tmp_path / "jax.npz.cgd"), jparams)
    flat = tio.load_flat(str(tmp_path / "jax.npz.cgd"))
    _assert_flat_equal(flat, flatten_pytree(jparams))
    unet = load_flat(tunet.UNet(tcfg), flat)

    own = {k: v.numpy() for k, v in unet.state_dict().items()}
    tio.save_flat(str(tmp_path / "port.npz.cgd"), own)
    back = jio.load_pytree_like(str(tmp_path / "port.npz.cgd"), jparams)
    _assert_flat_equal(flatten_pytree(back), own)


# ---------------------------------------------------------------------------
# weights_mode="auto" on a temporary checkpoints_dir
# ---------------------------------------------------------------------------

TOY_FLAGS = dict(image_size=32, attention_resolutions="16,8", num_channels=32, num_res_blocks=1,
                 channel_mult=(1, 2), class_cond=True, num_head_channels=16, learn_sigma=True,
                 use_scale_shift_norm=True, resblock_updown=True)


@pytest.fixture
def toy_registry(monkeypatch, tmp_path):
    """Both packages' registries with a toy 32px UNet (its .pt served from a
    file:// URL) and a toy ViT-B/32, and their .pt files in the reference
    layout: the UNet's in ``src/`` (to be downloaded), CLIP's in place."""
    src = tmp_path / "src"
    src.mkdir()
    jcfg = junet.UNetConfig.from_flags(TOY_FLAGS)
    tm = _torch_unet(jcfg, 5)
    torch.save(tm.adm_state_dict(), src / "toy_unet.pt")
    lookup = {"cond": {32: {"model_flags": TOY_FLAGS, "filename": "toy_unet.pt",
                            "url": (src / "toy_unet.pt").as_uri()}}}
    jclip_cfg, tclip_cfg = _clip_cfgs()
    monkeypatch.setattr(tweights, "DIFFUSION_LOOKUP", lookup)
    monkeypatch.setattr(jweights, "DIFFUSION_LOOKUP", lookup)
    monkeypatch.setattr(tweights, "CLIP_CONFIGS", {"ViT-B/32": tclip_cfg})
    monkeypatch.setattr(jweights, "CLIP_CONFIGS", {"ViT-B/32": jclip_cfg})
    ckpts = tmp_path / "ckpts"
    (ckpts / "clip").mkdir(parents=True)
    vit, txt = _clip_pair()
    torch.save(vit.clip_state_dict(txt), ckpts / "clip" / "ViT-B-32.pt")
    return dict(ckpts=ckpts, unet_sd=_numpy(tm.adm_state_dict()), jcfg=jcfg,
                clip_sd=_numpy(vit.clip_state_dict(txt)), jclip_cfg=jclip_cfg)


def _state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_resolve_unet_auto_downloads_converts_caches_and_hits_the_cache(toy_registry,
                                                                          monkeypatch):
    ckpts = str(toy_registry["ckpts"])
    unet, cfg, flags = tweights.resolve_unet(32, True, "auto", device="cpu",
                                             checkpoints_dir=ckpts)
    assert os.path.isfile(os.path.join(ckpts, "toy_unet.pt"))  # fetched from the file:// URL
    assert os.path.isfile(os.path.join(ckpts, "toy_unet.pt.npz.cgd"))
    want = flatten_pytree(junetconv.convert_state_dict(toy_registry["unet_sd"],
                                                       toy_registry["jcfg"]))
    _assert_flat_equal(_state(unet), want)
    assert flags["num_channels"] == 32 and cfg.model_channels == 32

    def refuse(*a, **k):
        raise AssertionError("converted again instead of reading the cache")

    monkeypatch.setattr(tunetconv, "convert_unet_checkpoint", refuse)
    os.remove(os.path.join(ckpts, "toy_unet.pt"))
    again, _, _ = tweights.resolve_unet(32, True, "auto", device="cpu", checkpoints_dir=ckpts)
    _assert_flat_equal(_state(again), want)
    # the port's cache is the JAX package's: cgd_tpu reads it without the .pt
    monkeypatch.setattr(junetconv, "convert_unet_checkpoint", refuse)
    jparams, _, _ = jweights.resolve_unet(32, True, ckpts, "auto")
    _assert_flat_equal(flatten_pytree(jax.tree.map(np.asarray, jparams)), want)


def test_resolve_clip_auto_and_a_custom_pt_convert_once(toy_registry, monkeypatch):
    ckpts = str(toy_registry["ckpts"])
    model, cfg = tweights.resolve_clip("ViT-B/32", "auto", "cpu", ckpts)
    cache = os.path.join(ckpts, "clip", "ViT-B-32.pt.npz.cgd")
    assert os.path.isfile(cache)
    want = flatten_pytree(jclipconv.convert_state_dict(toy_registry["clip_sd"],
                                                       toy_registry["jclip_cfg"]))
    _assert_flat_equal(_state(model), want)
    monkeypatch.setattr(tclipconv, "convert_clip_checkpoint",
                        lambda *a: (_ for _ in ()).throw(AssertionError("converted again")))
    again, _ = tweights.resolve_clip("ViT-B/32", "auto", "cpu", ckpts)
    _assert_flat_equal(_state(again), want)

    # a local .pt: the configuration inferred from its shapes, cached beside it
    custom = os.path.join(ckpts, "clip", "ViT-B-32.pt")
    model, cfg = tweights.resolve_clip(custom, "random", "cpu")
    assert cfg.vision.width == 64 and cfg.text.vocab_size == 96 and cfg.name == "ViT-B-32.pt"
    _assert_flat_equal(_state(model), want)
    with pytest.raises(FileNotFoundError):
        tweights.resolve_clip(os.path.join(ckpts, "missing.pt"), "auto", "cpu")


def test_resolve_lpips_auto_converts_into_the_checkpoint_dir(tmp_path, monkeypatch):
    from cgd_tpu.convert import torch_lpips as jlpipsconv

    cache_root = tmp_path / "cache"
    cache_root.mkdir()
    _, vgg_path, lin_path = _lpips_pth(cache_root)
    monkeypatch.setattr(tlpipsconv, "CACHE_PATH", str(cache_root))
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    model = tweights.resolve_lpips("auto", "cpu", str(ckpts))
    assert (ckpts / "lpips_vgg.npz.cgd").is_file()
    want = flatten_pytree(jlpipsconv.convert_lpips(vgg_path, lin_path))
    _assert_flat_equal(_state(model), want)
    os.remove(vgg_path)
    again = tweights.resolve_lpips("auto", "cpu", str(ckpts))
    _assert_flat_equal(_state(again), want)
    # random mode: the layout of the JAX package's init
    rand = tweights.resolve_lpips("random", "cpu")
    jrand = flatten_pytree(jax.tree.map(np.asarray, jlpips.init_vgg_lpips(jax.random.PRNGKey(0))))
    assert {k: v.shape for k, v in _state(rand).items()} == {k: v.shape for k, v in jrand.items()}
    assert all((v >= 0).all() for k, v in _state(rand).items() if k.startswith("lins"))


# ---------------------------------------------------------------------------
# the downloader
# ---------------------------------------------------------------------------

def test_download_copies_a_file_url_once(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(os.urandom(3000))
    root = tmp_path / "root"
    path = tdownload.download(src.as_uri(), "blob.pt", str(root))
    assert path == str(root / "blob.pt")
    assert (root / "blob.pt").read_bytes() == src.read_bytes()
    assert not (root / "blob.tmp").exists()
    src.write_bytes(b"changed")
    assert tdownload.download(src.as_uri(), "blob.pt", str(root)) == path  # reused as it is
    assert (root / "blob.pt").read_bytes() != b"changed"
    with tdownload.fetch(str(src)) as f:
        assert f.read() == b"changed"


def test_download_retries_with_backoff_then_raises(tmp_path, monkeypatch):
    calls, sleeps = [], []

    def failing(req, timeout):
        calls.append(req.full_url)
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", failing)
    monkeypatch.setattr(tdownload.time, "sleep", sleeps.append)
    with pytest.raises(tdownload.DownloadError, match="after 3 attempts: no route to host"):
        tdownload.download("https://example.invalid/x.pt", "x.pt", str(tmp_path))
    assert calls == ["https://example.invalid/x.pt"] * 3 and sleeps == [1, 2]
    assert list(tmp_path.iterdir()) == []
    (tmp_path / "d.pt").mkdir()
    with pytest.raises(tdownload.DownloadError, match="not a regular file"):
        tdownload.download("https://example.invalid/x.pt", "d.pt", str(tmp_path))


def test_download_refuses_a_short_body(tmp_path, monkeypatch):
    class Short:
        headers = {"Content-Length": "10"}

        def __init__(self):
            self.parts = [b"12345", b""]

        def read(self, n):
            return self.parts.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(urllib.request, "urlopen", lambda req, timeout: Short())
    monkeypatch.setattr(tdownload.time, "sleep", lambda s: None)
    with pytest.raises(tdownload.DownloadError, match="incomplete download: expected 10, got 5"):
        tdownload.download("https://example.invalid/x.pt", "x.pt", str(tmp_path))
    assert not (tmp_path / "x.pt").exists()


# ---------------------------------------------------------------------------
# chip_smoke.py's writers of reference-layout checkpoints (phase 8)
# ---------------------------------------------------------------------------

def _randomized(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(generator=gen)
    return module


def test_chip_smokes_reference_writers_invert_the_converters():
    """The inverse name maps phase 8 writes checkpoints with give the
    published key sets, and both packages' converters read them back to the
    port's parameters exactly (the UNet in the legacy qkv order)."""
    import chip_smoke

    jcfg, tcfg = _unet_cfgs()
    unet = _randomized(tunet.UNet(tcfg), 0)
    sd = _numpy(chip_smoke.unet_reference_sd(unet))
    assert sorted(sd) == sorted(TorchADMUNet(jcfg).adm_state_dict())
    _assert_flat_equal(tunetconv.convert_state_dict(sd, tcfg), _state(unet))
    _assert_flat_equal(flatten_pytree(junetconv.convert_state_dict(sd, jcfg)), _state(unet))

    vit, txt = _clip_pair()
    jccfg, tccfg = _clip_cfgs()
    clip = _randomized(tclip.CLIP(tccfg), 1)
    sd = _numpy(chip_smoke.clip_reference_sd(clip))
    assert sorted(sd) == sorted(vit.clip_state_dict(txt))
    _assert_flat_equal(tclipconv.convert_state_dict(sd, tccfg), _state(clip))
    _assert_flat_equal(flatten_pytree(jclipconv.convert_state_dict(sd, jccfg)), _state(clip))

    lpips = _randomized(tlpips.VGGLPIPS(), 2)
    vgg_sd, lin_sd = chip_smoke.lpips_reference_sds(lpips)
    _assert_flat_equal(tlpipsconv.convert_state_dicts(vgg_sd, lin_sd), _state(lpips))
