"""The port's class-conditional, ancestral path with a ModifiedResNet CLIP
tower, through ``api.clip_guided_diffusion`` with ``weights_mode="auto"``,
against the benchmark's plain float32 reference (``bench_h100/reference``:
plain PyTorch, nothing of the port) on the same seeded published weights,
on the CPU at a small size. It is the ``acc512`` cell's path (512px
class-conditional ADM whose ``channel_mult`` starts at 0.5, rescaled
timesteps, the learned variance, class labels drawn every step, CLIP
RN50x16, respacing "1000") at toy widths: a 128px UNet of 32 / 64 / 64 / 128
channels (128px, as the guidance at 64px normalises the gradient's
magnitude, which the reference leaves out), a ResNet tower of widths 4 to
256 at 64px with a 2-head attention pool.

- The frames the API writes at steps 0-3 equal the reference's to within
  1e-4 of full scale (the mean absolute difference of the uint8 frames, as
  the benchmark's check reads it). Both sides compute in float32 from the
  same weights and the same generator draws; they differ only in the order
  of summations (NHWC against NCHW, fused against plain), some 1e-6 of a
  value, which reaches the 8-bit frame as a level in a few pixels: one
  level in one pixel of 128 x 128 x 3 is 8e-8 of full scale.
- The guidance gradient of step 0 with respect to x (the loss through the
  cutouts, the ResNet tower, the blend and the UNet) equals the
  reference's to a relative L2 of 1e-4: float32 rounding through some
  60 layers forward and back is some 1e-6 relative, amplified where the
  spherical distance and the attention pool's softmax are steep; 1e-4
  leaves that room and is still a thousand times under what a dropped or
  mis-scaled term moves.
- The port's ``guidance.clip`` span names the ResNet tower.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench_h100.harness import weights as wmod  # noqa: E402
from bench_h100.reference import png  # noqa: E402
from bench_h100.reference.sampling import Reference, compare  # noqa: E402
from cgd_tpu_torch import api as tapi  # noqa: E402
from cgd_tpu_torch import weights as tweights  # noqa: E402
from cgd_tpu_torch.io_utils import download  # noqa: E402
from cgd_tpu_torch.models.clip import configs as tconfigs  # noqa: E402
from cgd_tpu_torch.models.clip import tokenizer as ttok  # noqa: E402
from cgd_tpu_torch.utils import tracing  # noqa: E402
from tests.test_torch_port_adm512c_cuda import _grads  # noqa: E402
from tests.torch_port_toy_checkpoints import no_kept_models  # noqa: E402,F401

torch.set_num_threads(2)

UNET = dict(cache="toy_cond.pt.npz.cgd", image_size=128, class_cond=True, num_channels=64,
            num_res_blocks=1, channel_mult=[0.5, 1, 1, 2], attention_resolutions="16",
            num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True,
            learn_sigma=True, use_new_attention_order=False, diffusion_steps=1000,
            noise_schedule="linear", rescale_timesteps=True)
CLIP = dict(name="RN50x16", cache="clip/RN50x16.pt.npz.cgd", embed_dim=16,
            vision=dict(kind="resnet", resolution=64, width=8, layers=[1, 2, 1, 1], heads=2),
            text=dict(context_length=77, vocab_size=49408, width=32, heads=2, layers=1))
CONFIG = dict(unet=UNET, clip=CLIP, compute_dtype="float32")
CALL = dict(num_cutouts=4, clip_guidance_scale=1500, tv_scale=150, range_scale=50,
            save_frequency=1, skip_timesteps=0, init_scale=0, randomize_class=True,
            prompts=["a fox in the snow"], image_size=128, class_cond=True,
            clip_model_name="RN50x16", compute_dtype="float32")
STEPS = 4


def _install(monkeypatch, tmp_path):
    """The seeded published weights, the port's caches written from them,
    the registries at the toy widths, a merge table; the reference's weights
    and the table's path."""
    flags = {k: v for k, v in UNET.items() if k != "cache"}
    monkeypatch.setattr(tweights, "DIFFUSION_LOOKUP", {"cond": {128: {
        "model_flags": flags, "filename": UNET["cache"][:-len(".npz.cgd")],
        "url": "https://example.invalid/toy_cond.pt"}}})
    v = CLIP["vision"]
    cfg = tconfigs.CLIPConfig(
        "RN50x16", CLIP["embed_dim"],
        tconfigs.VisionResNetConfig(v["resolution"], v["width"], tuple(v["layers"]), v["heads"]),
        tconfigs.TextConfig(**CLIP["text"]))
    monkeypatch.setattr(tweights, "CLIP_CONFIGS", {"RN50x16": cfg})
    cache = tmp_path / "home" / ".cache" / "clip-guided-diffusion"
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(download, "CACHE_PATH", str(cache))
    monkeypatch.setattr(ttok, "_DEFAULT_TOKENIZER", None)
    bpe = str(cache / "bpe_simple_vocab_16e6.txt.gz")
    wmod.write_merge_table(bpe, 3, CALL["prompts"][0].split())
    weights = wmod.make_weights(CONFIG, 5, "cpu", False)
    wmod.write_caches(CONFIG, weights, str(tmp_path / "ckpts"))
    ref = {k: {n: torch.from_numpy(np.asarray(t)) for n, t in sd.items()}
           for k, sd in weights.items()}
    return ref, bpe


@pytest.mark.parametrize("respacing,batch", [("1000", 1), ("50", 2)],
                         ids=["respace1000-b1", "respace50-b2"])
def test_the_resnet_ancestral_path_equals_the_reference(tmp_path, monkeypatch, respacing,
                                                         batch):
    ref_weights, bpe = _install(monkeypatch, tmp_path)
    call = dict(CALL, timestep_respacing=respacing, batch_size=batch, seed=2100000017)
    grads = _grads(monkeypatch)
    monkeypatch.chdir(tmp_path)
    tracing.take()
    tracing.enable()
    got = {}
    try:
        gen = tapi.clip_guided_diffusion(**call, checkpoints_dir=str(tmp_path / "ckpts"),
                                         prefix_path=str(tmp_path / "frames"),
                                         weights_mode="auto", device="cpu", progress=False)
        for b, path in gen:
            step = int(os.path.basename(path)[:-4])
            with open(path, "rb") as f:
                got.setdefault(step, {})[b] = png.decode(f.read())
            if step == STEPS - 1 and b == batch - 1:
                break
        gen.close()
    finally:
        tracing.disable()
        spans = tracing.take()
    port_grad = grads[0]
    clip_spans = [s for s in spans if s.name == "guidance.clip"]
    assert len(clip_spans) >= STEPS - 1
    assert all(s.counts == {"tower": "resnet", "images": 4 * batch, "resolution": 64}
               for s in clip_spans)

    del grads[:]
    want = dict(Reference(CONFIG, ref_weights, "cpu", "float32", bpe).frames(call, STEPS - 1))
    ref_grad = grads[0]
    assert sorted(got) == sorted(want) == list(range(STEPS))
    for step in range(STEPS):
        for b in range(batch):
            assert compare(got[step][b], want[step][b]) <= 1e-4, (step, b)
    assert port_grad.shape == ref_grad.shape == (batch, 128, 128, 3)
    rel = float((port_grad - ref_grad).norm() / ref_grad.norm())
    assert ref_grad.norm() > 0 and rel <= 1e-4, rel
