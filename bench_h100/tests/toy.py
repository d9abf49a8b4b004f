"""A toy cell for the benchmark's CPU tests: a copy of the benchmark in a
temporary root with one more configuration (a 128px UNet and a ViT of toy
widths, the published vocabulary), one more traffic mix (ddim10, 4
cutouts, a frame every 5 steps) and its cell, with the port's registries
pointed at the toy widths. ``run`` drives the harness's whole run on the
CPU, the card's look skipped."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # bench_h100/
REPO = os.path.dirname(HERE)

UNET = dict(cache="toy_unet.pt.npz.cgd", image_size=128, class_cond=False, num_channels=32,
            num_res_blocks=1, channel_mult=[1, 2, 2], attention_resolutions="32",
            num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True,
            learn_sigma=True, use_new_attention_order=False, diffusion_steps=1000,
            noise_schedule="linear", rescale_timesteps=False)
CLIP = dict(name="ViT-B/32", cache="clip/ViT-B-32.pt.npz.cgd", embed_dim=16,
            vision=dict(kind="vit", resolution=32, patch=8, width=32, layers=1, heads=2),
            text=dict(context_length=77, vocab_size=49408, width=32, heads=2, layers=1))
CALL = dict(timestep_respacing="ddim10", num_cutouts=4, clip_guidance_scale=100, tv_scale=150,
            range_scale=50, save_frequency=5, batch_size=1, skip_timesteps=0, init_scale=0,
            randomize_class=False)
PHRASES = ["a lighthouse in a storm", "a fox in the snow", "a city at night"]


def make_root(tmp, name="toy", compute_dtype="float32", call=None, init=False, limit=0.01,
              unet=None, close="frame") -> str:
    """A benchmark root under ``tmp`` holding the real benchmark's files and
    the toy cell ``name``. Returns the root."""
    root = os.path.join(str(tmp), "root")
    if not os.path.exists(root):
        shutil.copytree(HERE, os.path.join(root, "bench_h100"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    b = os.path.join(root, "bench_h100")
    cfg = dict(name=f"{name}-cfg", compute_dtype=compute_dtype, checkpoint_dtype="float16",
               reduced=["checkpoint_dtype"], unet=dict(unet or UNET), clip=CLIP,
               lpips=dict(cache="lpips_vgg.npz.cgd"))
    with open(os.path.join(b, "configs", f"{name}-cfg.json"), "w") as f:
        json.dump(cfg, f)
    traffic = dict(call=dict(call or CALL), init_image=init,
                   prompts=dict(per_request=1, phrases=PHRASES), window=dict(close=close),
                   trace=dict(from_step=5, steps=0), check=dict(requests=1, steps=[0, 5]))
    with open(os.path.join(b, "traffic", f"{name}.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(b, "limits", f"{name}.json"), "w") as f:
        json.dump({f"frame_mad_s{s}": {"limit": limit} for s in (0, 5)}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name=f"{name}-cfg", source="toy",
                                 file=f"bench_h100/configs/{name}-cfg.json", reduced=[], why="toy"))
    bench["workloads"].append(dict(name=name, config=f"{name}-cfg", traffic=name, chips=1,
                                   why="toy"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def patch_port(monkeypatch, tmp, unet=None) -> None:
    """The port's registries at the toy widths, its download cache and its
    tokenizer cache emptied, HOME under ``tmp``."""
    from cgd_tpu_torch import weights as tweights
    from cgd_tpu_torch.io_utils import download
    from cgd_tpu_torch.models.clip import configs as tconfigs
    from cgd_tpu_torch.models.clip import tokenizer as ttok

    u = dict(unet or UNET)
    flags = {k: v for k, v in u.items() if k != "cache"}
    lookup = {"cond" if u["class_cond"] else "uncond": {u["image_size"]: {
        "model_flags": flags, "filename": u["cache"][:-len(".npz.cgd")],
        "url": "https://example.invalid/toy.pt"}}}
    monkeypatch.setattr(tweights, "DIFFUSION_LOOKUP", lookup)
    v, t = CLIP["vision"], CLIP["text"]
    cfg = tconfigs.CLIPConfig("ViT-B/32", CLIP["embed_dim"],
                              tconfigs.VisionViTConfig(v["resolution"], v["patch"], v["width"],
                                                       v["layers"], v["heads"]),
                              tconfigs.TextConfig(**t))
    monkeypatch.setattr(tweights, "CLIP_CONFIGS", {"ViT-B/32": cfg})
    home = os.path.join(str(tmp), "run", "home")
    monkeypatch.setenv("HOME", home)
    monkeypatch.setattr(download, "CACHE_PATH",
                        os.path.join(home, ".cache", "clip-guided-diffusion"))
    monkeypatch.setattr(ttok, "_DEFAULT_TOKENIZER", None)


def run(monkeypatch, tmp, root, name="toy", seed=5, seconds=0.5, trace=False, unet=None):
    import time

    from bench_h100.harness import window

    patch_port(monkeypatch, tmp, unet)
    run_dir = os.path.join(str(tmp), "run")
    os.makedirs(run_dir, exist_ok=True)
    monkeypatch.chdir(run_dir)
    return window.run(root, name, seed, seconds, trace, run_dir, time.perf_counter(),
                      device="cpu")
