"""The benchmark's weights on the CPU at toy size: the frozen name maps give
the port's converters' parameters, the caches round-trip through the
port's flat npz format, the port loads a half-precision cache into the
same float32 parameters as a float32 one, and the draws repeat by seed."""

import os

import numpy as np
import pytest
import torch

from bench_h100.harness import name_map
from bench_h100.harness import weights as wmod
from bench_h100.tests import toy
from bench_h100.tests.test_bench_h100_counts import RESNET

CONFIG = dict(unet=dict(toy.UNET, class_cond=True), clip=toy.CLIP)


def _as_float(sd):
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("clip", [toy.CLIP, RESNET], ids=["vit", "resnet"])
def test_name_maps_equal_the_ports_converters(clip):
    from cgd_tpu_torch.convert import torch_clip, torch_lpips, torch_unet
    from cgd_tpu_torch.models.clip import configs as tconfigs
    from cgd_tpu_torch.models.unet import UNetConfig

    cfg = dict(CONFIG, clip=clip)
    w = wmod.make_weights(cfg, 9, "cpu", True)
    ours = {k: _as_float(v) for k, v in (("unet", name_map.unet(w["unet"], cfg["unet"])),
                                         ("clip", name_map.clip(w["clip"])),
                                         ("lpips", name_map.lpips(w["lpips"])))}
    v, t = clip["vision"], tconfigs.TextConfig(**clip["text"])
    if v["kind"] == "vit":
        vis = tconfigs.VisionViTConfig(v["resolution"], v["patch"], v["width"], v["layers"],
                                       v["heads"])
    else:
        vis = tconfigs.VisionResNetConfig(v["resolution"], v["width"], tuple(v["layers"]),
                                          v["heads"])
    theirs = {
        "unet": torch_unet.convert_state_dict(_as_float(w["unet"]),
                                              UNetConfig.from_flags(cfg["unet"])),
        "clip": torch_clip.convert_state_dict(_as_float(w["clip"]),
                                              tconfigs.CLIPConfig("toy", clip["embed_dim"], vis, t)),
        "lpips": torch_lpips.convert_state_dicts(
            {k: v for k, v in w["lpips"].items() if k.startswith("features")},
            {k: v for k, v in w["lpips"].items() if k.startswith("lin")}),
    }
    for kind in ours:
        assert sorted(ours[kind]) == sorted(theirs[kind]), kind
        for k in ours[kind]:
            np.testing.assert_allclose(ours[kind][k], theirs[kind][k], rtol=1e-6, atol=0, err_msg=k)


def test_caches_round_trip_through_the_flat_npz(tmp_path):
    from cgd_tpu_torch.utils import pytree_io

    w = wmod.make_weights(CONFIG, 4, "cpu", False)
    flat = name_map.unet(w["unet"], CONFIG["unet"])
    path = str(tmp_path / "u.pt.npz.cgd")
    assert wmod.write_cache(path, flat) == os.path.getsize(path)
    back = pytree_io.load_flat(path)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype and (back[k] == flat[k]).all()
    assert {str(v.dtype) for v in back.values()} == {"float16", "float32"}


def test_the_port_loads_a_half_precision_cache_as_float32(tmp_path, monkeypatch):
    from cgd_tpu_torch import weights as tweights

    toy.patch_port(monkeypatch, tmp_path)
    w = wmod.make_weights(dict(CONFIG, unet=dict(toy.UNET)), 6, "cpu", False)
    flat = name_map.unet(w["unet"], dict(toy.UNET))
    loaded = []
    for name, arrays in (("half", flat), ("full", _as_float(flat))):
        ckpts = tmp_path / name
        wmod.write_cache(str(ckpts / toy.UNET["cache"]), arrays)
        unet, _, _ = tweights.resolve_unet(128, False, "auto", device="cpu",
                                           checkpoints_dir=str(ckpts))
        loaded.append({k: v.clone() for k, v in unet.state_dict().items()})
    assert any(v.dtype == np.float16 for v in flat.values())
    assert sorted(loaded[0]) == sorted(loaded[1])
    for k in loaded[0]:
        assert loaded[0][k].dtype == torch.float32
        assert torch.equal(loaded[0][k], loaded[1][k]), k


def test_draws_repeat_by_seed_and_follow_their_rules():
    a = wmod.make_weights(CONFIG, 12, "cpu", True)
    b = wmod.make_weights(CONFIG, 12, "cpu", True)
    c = wmod.make_weights(CONFIG, 13, "cpu", True)
    for kind in a:
        for k in a[kind]:
            assert (a[kind][k] == b[kind][k]).all()
    assert not (a["unet"]["out.2.weight"] == c["unet"]["out.2.weight"]).all()
    # zero-initialised when published; its variance rows keep the draw
    out = a["unet"]["out.2.weight"][3:].astype(np.float32)
    assert abs(out.std() * np.sqrt(np.prod(out.shape[1:])) - 1) < 0.1
    assert a["unet"]["out.2.weight"].dtype == np.float16
    assert a["unet"]["out.0.weight"].dtype == np.float32
    assert abs(a["unet"]["out.0.weight"][6:].mean() - 1) < 0.05  # past the path's channels
    assert (a["lpips"]["lin0.model.1.weight"] >= 0).all()


@pytest.mark.parametrize("channels", [32, 64, 256])
def test_the_unet_predicts_its_input_as_the_noise(channels):
    """``denoiser_path``: eps = x to within ``RANDOM_EPS`` of the random
    network's output, at every t and at twice the scale (GroupNorm's groups
    of 1, 2 and 8 channels)."""
    from bench_h100.reference.adm import ADMUNet

    flags = dict(toy.UNET, num_channels=channels, channel_mult=[1, 2], image_size=32,
                 attention_resolutions="16")
    w = wmod.make_weights(dict(unet=flags, clip=toy.CLIP), 3, "cpu", False)
    with torch.device("meta"):
        unet = ADMUNet(flags)
    unet.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                          for k, v in w["unet"].items()}, strict=True, assign=True)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    x = x - x.mean(dim=(2, 3), keepdim=True)  # GroupNorm takes out each group's mean
    with torch.no_grad():
        for t in (999.0, 500.0, 0.0):
            for scale in (1.0, 2.0):
                err = (unet(scale * x, torch.full((2,), t))[:, :3] - scale * x).square().mean()
                assert 0.05 * wmod.RANDOM_EPS < err.sqrt() < 2 * wmod.RANDOM_EPS, (t, scale)


def test_merge_table_has_the_published_size(tmp_path):
    from bench_h100.reference.bpe import SimpleTokenizer

    path = str(tmp_path / "bpe.txt.gz")
    wmod.write_merge_table(path, 3, {"lighthouse", "storm"})
    tok = SimpleTokenizer(path)
    assert tok.vocab_size == 49408
    ids = tok.tokenize(["a lighthouse in a storm"])[0]
    assert ids[0] == 49406 and 49407 in ids and (ids < 49408).all()
    assert tok.encode("lighthouse") == [tok.encoder["lighthouse</w>"]]
