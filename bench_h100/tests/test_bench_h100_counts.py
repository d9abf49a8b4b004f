"""The benchmark's counts on the CPU: the FLOP count of a guided step against
``torch.utils.flop_counter`` over the reference's step, and the UNet's 3x3
convolutions of the conv bound against the shapes walked on the meta
device."""

import json
import os

import numpy as np
import pytest
import torch

from bench_h100.counts import conv3x3_bound, guided_step_flops
from bench_h100.harness import weights as wmod
from bench_h100.reference import png
from bench_h100.reference.layers import Conv2d
from bench_h100.reference.sampling import Reference
from bench_h100.tests import toy

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET = dict(name="RN50x16", cache="clip/RN50x16.pt.npz.cgd", embed_dim=16,
              vision=dict(kind="resnet", resolution=64, width=8, layers=[1, 2, 1, 1], heads=2),
              text=dict(context_length=77, vocab_size=49408, width=32, heads=2, layers=1))
UNET = dict(toy.UNET, image_size=64, channel_mult=[1, 2], attention_resolutions="32")


class _Global:
    """FlopCounterMode's module tracker hooks every module output's backward,
    which ``torch.autograd.grad`` refuses: count globally only."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _config(clip, unet=UNET):
    return dict(unet=dict(unet), clip=clip, compute_dtype="float32")


def _step_flops(tmp_path, config, call, until):
    from torch.utils.flop_counter import FlopCounterMode

    weights = wmod.make_weights(config, 3, "cpu", bool(call.get("init_scale")))
    bpe = str(tmp_path / "bpe.txt.gz")
    wmod.write_merge_table(bpe, 3, ["a", "fox"])
    ref = Reference(config, {k: {n: torch.from_numpy(np.asarray(v)) for n, v in sd.items()}
                             for k, sd in weights.items()}, "cpu", "float32", bpe)
    fc = FlopCounterMode(display=False)
    fc.mod_tracker = _Global()
    with fc:
        ref.frames(call, until)
    return fc.get_total_flops()


@pytest.mark.parametrize("clip,batch,init", [(toy.CLIP, 1, False), (toy.CLIP, 2, False),
                                             (RESNET, 1, False), (toy.CLIP, 1, True)],
                         ids=["vit", "vit-b2", "resnet", "vit-lpips"])
def test_guided_step_flops_equal_the_flop_counter(tmp_path, clip, batch, init):
    """One guided step of the reference = (step 0 and the forward of step 1)
    minus (the forward of step 0): the text encoder counts in both."""
    config = _config(clip)
    call = dict(toy.CALL, batch_size=batch, image_size=64, seed=1, prompts=["a fox"],
                save_frequency=1, init_scale=1000 if init else 0)
    if init:
        path = tmp_path / "init.png"
        wmod.write_init_image(str(path), 1, 64)
        call["init_image"] = str(path)
    counted = _step_flops(tmp_path, config, call, 1) - _step_flops(tmp_path, config, call, 0)
    assert counted == guided_step_flops.flops(config, call)


def test_the_cells_counts():
    """The 256px ViT-B/32 step is about 4.8e12 FLOPs (the port's own bench
    count); the init image adds the VGG16 (about 0.12e12 at 256px); batch 4
    four times the whole step."""
    with open(os.path.join(HERE, "configs", "adm256u-vitb32.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", "cog256.json")) as f:
        call = json.load(f)["call"]
    one = guided_step_flops.flops(cfg, call)
    assert 4.5e12 < one < 5.1e12
    assert 1.02 * one < guided_step_flops.flops(cfg, dict(call, init_scale=1000)) < 1.04 * one
    assert guided_step_flops.flops(cfg, dict(call, batch_size=4)) == 4 * one


def _walked(flags, b):
    """The 3x3 convs of the reference UNet's forward on the meta device."""
    from bench_h100.reference.adm import ADMUNet

    seen = []
    with torch.device("meta"):
        unet = ADMUNet(flags)

        def hook(mod, inp, out):
            if mod.weight.shape[-1] == 3:
                seen.append((mod.weight.shape[1], mod.weight.shape[0], inp[0].shape[-1],
                             out.shape[-1]))

        for m in unet.modules():
            if isinstance(m, Conv2d):
                m.register_forward_hook(hook)
        size = flags["image_size"]
        unet(torch.empty(b, 3, size, size), torch.empty(b),
             torch.zeros(b, dtype=torch.long) if flags.get("class_cond") else None)
    return seen


@pytest.mark.parametrize("config,batch", [("adm256u-vitb32", 1), ("adm256u-vitb32", 4),
                                          ("adm512c-rn50x16", 1), ("toy", 2)])
def test_conv_bound_walks_the_unet(config, batch):
    if config == "toy":
        flags = dict(toy.UNET, class_cond=True)
    else:
        with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
            flags = json.load(f)["unet"]
    counted = [(c["cin"], c["cout"], c["res_in"], c["res_out"])
               for c in conv3x3_bound.convs(flags, batch)]
    walked = _walked(flags, batch)
    assert len(counted) == len(walked)
    for (ci, co, ri, ro), (wci, wco, wri, wro) in zip(counted, walked):
        assert (ci, co, ro) == (wci, wco, wro)
        # an up-sampling ResBlock's conv reads its input before the 2x
        # nearest upsample, which the port fuses into the conv's load
        assert ri == (wri if ri == ro else wri // 2)


def test_conv_bound_is_the_larger_of_flops_and_bytes():
    flags = dict(toy.UNET)
    call = dict(batch_size=1)
    cfg = dict(unet=flags)
    fast_mem = conv3x3_bound.seconds(cfg, call, 1e12, 1e30)
    fast_math = conv3x3_bound.seconds(cfg, call, 1e30, 1e12)
    both = conv3x3_bound.seconds(cfg, call, 1e12, 1e12)
    assert both >= max(fast_mem, fast_math) and both <= fast_mem + fast_math


def test_png_round_trip_and_filters():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (7, 5, 3)).astype(np.uint8)
    assert (png.decode(png.encode(img)) == img).all()
    # a hand-filtered file: row filters 1-4 undone
    import struct
    import zlib

    raw = img.reshape(7, 15).astype(np.int32)
    rows = []
    prior = np.zeros(15, np.int32)
    for y in range(7):
        ftype = (y % 4) + 1
        line = raw[y]
        left = np.concatenate([[0, 0, 0], line[:-3]])
        upleft = np.concatenate([[0, 0, 0], prior[:-3]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            pred = png._paeth(left, prior, upleft)
        rows.append(bytes([ftype]) + ((line - pred) & 255).astype(np.uint8).tobytes())
        prior = line
    data = (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 7, 8, 2, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows))) + png._chunk(b"IEND", b""))
    assert (png.decode(data) == img).all()


def test_peaks_table():
    from bench_h100.harness.cells import peak

    root = os.path.dirname(HERE)
    assert peak(root, "NVIDIA H100 80GB HBM3", "bf16_dense_flops") == 989e12
    assert peak(root, "NVIDIA H100 PCIe", "bf16_dense_flops") == 756e12
    assert peak(root, "NVIDIA A100-SXM4-80GB", "bf16_dense_flops") is None
    assert peak(root, "NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
