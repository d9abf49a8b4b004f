"""Toy checkpoints in the reference layout for the port's ``weights_mode="auto"``
tests: a 64px class-conditional ADM UNet and a ViT CLIP from the torch
replicas of tests/torch_ref_models.py, written as the published ``.pt``
files into a ``checkpoints_dir``, with both packages' registries pointed at
their toy configurations and the port's default tokenizer built from a tiny
BPE merge table (the real tables and weights are not in the repository).

A test module that resolves these files imports ``no_kept_models``, so that
each of its tests leaves the port's model cache (``cgd_tpu_torch/weights.py``)
empty."""

from __future__ import annotations

import pytest
import torch

from cgd_tpu import weights as jweights
from cgd_tpu.models import unet as junet
from cgd_tpu.models.clip import configs as jconfigs
from cgd_tpu_torch import weights as tweights
from cgd_tpu_torch.models.clip import configs as tconfigs
from cgd_tpu_torch.models.clip import tokenizer as ttok
from cgd_tpu_torch.convert import torch_lpips as tlpipsconv
from tests.torch_ref_models import TorchADMUNet, TorchCLIPText, TorchCLIPViT, TorchLPIPSVgg

FLAGS = dict(image_size=64, attention_resolutions="32", num_channels=32, num_res_blocks=1,
             channel_mult=(1, 2), class_cond=True, num_head_channels=16, learn_sigma=True,
             use_scale_shift_norm=True, resblock_updown=True)
MERGES = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>", "h e", "he l", "hel l",
          "hell o</w>"]
VOCAB = 256 * 2 + len(MERGES) + 2  # bytes, bytes</w>, merges, the two specials
TEXT = dict(context_length=16, vocab_size=VOCAB, width=32, heads=2, layers=1)
VISION = (32, 8, 32, 1, 2)  # input resolution, patch, width, layers, heads


@pytest.fixture(autouse=True)
def no_kept_models():
    """The test's kept models dropped after it, memory and all."""
    yield
    tweights.clear_model_cache()


def write_lpips_pth(root) -> TorchLPIPSVgg:
    """torchvision's VGG16 ``.pth`` (its features) and lpips' head ``.pth``
    under their cache names in ``root``, from the torch replica."""
    torch.manual_seed(4)
    tm = TorchLPIPSVgg().eval()
    vgg = {}
    for i, cid in enumerate(tlpipsconv.CONV_IDS):
        vgg[f"features.{cid}.weight"] = tm.convs[i].weight.detach().clone()
        vgg[f"features.{cid}.bias"] = tm.convs[i].bias.detach().clone()
    lin = {f"lin{i}.model.1.weight": w.detach().clone().view(1, -1, 1, 1)
           for i, w in enumerate(tm.lins)}
    root.mkdir(parents=True, exist_ok=True)
    torch.save(vgg, root / "vgg16-397923af.pth")
    torch.save(lin, root / "lpips_vgg_v0.1.pth")
    return tm


def install(monkeypatch, tmp_path, ckpts, lpips: bool = False) -> dict:
    """Write the toy ``.pt`` files into ``ckpts`` and patch the registries
    and the tokenizer (undone by ``monkeypatch``); with ``lpips`` also the
    two LPIPS ``.pth`` files, into a patched download cache. Returns the
    reference state dicts and configurations."""
    if lpips:
        write_lpips_pth(tmp_path / "cache")
        monkeypatch.setattr(tlpipsconv, "CACHE_PATH", str(tmp_path / "cache"))
    jcfg = junet.UNetConfig.from_flags(FLAGS)
    torch.manual_seed(11)
    unet = TorchADMUNet(jcfg).eval()
    with torch.no_grad():  # the zero-init output convs re-drawn: a nonzero model
        for p in unet.parameters():
            if not p.abs().sum():
                p.normal_(0, 0.02)
    vit = TorchCLIPViT(*VISION, embed_dim=16)
    txt = TorchCLIPText(vocab=VOCAB, ctx=TEXT["context_length"], width=32, heads=2, layers=1,
                        embed_dim=16)
    ckpts.mkdir(parents=True, exist_ok=True)
    (ckpts / "clip").mkdir(exist_ok=True)
    unet_sd, clip_sd = unet.eval().adm_state_dict(), vit.eval().clip_state_dict(txt)
    torch.save(unet_sd, ckpts / "toy_unet.pt")
    torch.save(clip_sd, ckpts / "clip" / "ViT-B-32.pt")

    lookup = {"cond": {64: {"model_flags": FLAGS, "filename": "toy_unet.pt",
                            "url": "https://example.invalid/toy_unet.pt"}}}
    jclip_cfg = jconfigs.CLIPConfig("ViT-B/32", 16, jconfigs.VisionViTConfig(*VISION),
                                    jconfigs.TextConfig(**TEXT))
    tclip_cfg = tconfigs.CLIPConfig("ViT-B/32", 16, tconfigs.VisionViTConfig(*VISION),
                                    tconfigs.TextConfig(**TEXT))
    for mod, cfg in ((tweights, tclip_cfg), (jweights, jclip_cfg)):
        monkeypatch.setattr(mod, "DIFFUSION_LOOKUP", lookup)
        monkeypatch.setattr(mod, "CLIP_CONFIGS", {"ViT-B/32": cfg})
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: tiny\n" + "\n".join(MERGES) + "\n")
    monkeypatch.setattr(ttok, "_DEFAULT_TOKENIZER", ttok.SimpleTokenizer(str(merges), VOCAB - 256))
    return dict(unet_sd={k: v.numpy() for k, v in unet_sd.items()}, jcfg=jcfg,
                clip_sd={k: v.numpy() for k, v in clip_sd.items()}, jclip_cfg=jclip_cfg)
