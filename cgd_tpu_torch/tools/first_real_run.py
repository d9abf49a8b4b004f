"""The runbook for the first machine that reaches the network: download and
convert the published weights, run BASELINE.md's acceptance configuration
1 through the port's API, and CLIP-score its output. Counterpart of the JAX
package's ``tools/first_real_run.py``, with the same phases and report.

    python -m cgd_tpu_torch.tools.first_real_run                 # the full protocol, on the card
    python -m cgd_tpu_torch.tools.first_real_run --dry-run       # no network: toy random models
    python -m cgd_tpu_torch.tools.first_real_run --dry-run --device cpu

Phases (each prints PASS; the first failure raises and exits non-zero):

1. ``resolve_unet_64``, ``resolve_clip_vit_b32``, ``resolve_lpips_vgg``:
   the 64px class-conditional ADM checkpoint, ViT-B/32 and the LPIPS VGG16
   through ``weights.resolve_*`` in ``auto`` mode (download, convert, the
   ``.npz.cgd`` cache), each with its parameter count (every tensor of the
   module's state, what the JAX package's ``_count_params`` counts of its
   pytree) held above a floor, so that a truncated download fails;
2. ``cache_hit``: resolving again reads the converted cache
   (``weights._converted_path``);
3. ``acceptance_config_1``: 64px, ddim25, ViT-B/32, one prompt, batch 1,
   seed 7, a frame every 5 steps, 16 cutouts, through
   ``api.clip_guided_diffusion``;
4. ``clip_score``: the last frame scored by ``python -m
   cgd_tpu_torch.tools.clip_score`` in a subprocess on the same
   ``--device``;
5. the report, ``<out>/first_real_run_report.json``: the phases, the
   device (the torch device and the card's name) and the parity table's
   port column; the reference's column comes from the same clip_score
   command run on the PyTorch reference's output at the same configuration.

``--dry-run`` runs every phase offline: random weights with the toy models
(``CGD_TPU_DEBUG_TINY=1``), no floors, 2 cutouts, ``cache_hit`` skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from cgd_tpu_torch import api
from cgd_tpu_torch.io_utils.download import CACHE_PATH
from cgd_tpu_torch.registry import DIFFUSION_LOOKUP
from cgd_tpu_torch.weights import (
    _converted_path,
    clear_model_cache,
    resolve_clip,
    resolve_lpips,
    resolve_unet,
)

PROMPT = "an impressionist painting of a lighthouse at dawn"
ROOT = Path(__file__).resolve().parents[2]
# parameter floors of the published weights: the 64px ADM ~270M, ViT-B/32
# ~150M, torchvision's VGG16 features + the lpips v0.1 heads ~14.7M
FLOORS = {"resolve_unet_64": 2e8, "resolve_clip_vit_b32": 1e8, "resolve_lpips_vgg": 1.4e7}


def count_params(module: torch.nn.Module) -> int:
    """Every tensor of the module's state: the leaves of the JAX pytree."""
    return sum(t.numel() for t in module.state_dict().values())


def run(dry_run: bool, out: str, checkpoints_dir: str = CACHE_PATH, device="cuda") -> dict:
    """The protocol; returns the report (also written to ``out``)."""
    dev = api.resolve_device(device)
    mode = "random" if dry_run else "auto"
    if dry_run:
        os.environ.setdefault("CGD_TPU_DEBUG_TINY", "1")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    report = {"mode": mode, "device": {"torch": str(dev), "name": name}, "phases": {}}

    def phase(p):
        print(f"\n=== {p} ===", flush=True)
        report["phases"][p] = {"t0": time.time()}

    def done(p, **extra):
        report["phases"][p]["seconds"] = round(time.time() - report["phases"][p].pop("t0"), 1)
        report["phases"][p].update(extra)
        print(f"PASS: {p} {extra}", flush=True)

    def counted(p, module, **extra):
        n = count_params(module)
        if not dry_run and n <= FLOORS[p]:
            raise RuntimeError(f"{p}: parameter count suspicious: {n} (floor {FLOORS[p]:.3g})")
        done(p, params=n, **extra)

    phase("resolve_unet_64")
    unet, _, flags = resolve_unet(64, True, mode, device=dev, checkpoints_dir=checkpoints_dir)
    counted("resolve_unet_64", unet, schedule=flags.get("noise_schedule"))
    phase("resolve_clip_vit_b32")
    clip, _ = resolve_clip("ViT-B/32", mode, dev, checkpoints_dir)
    counted("resolve_clip_vit_b32", clip)
    phase("resolve_lpips_vgg")
    lpips = resolve_lpips(mode, dev, checkpoints_dir)
    counted("resolve_lpips_vgg", lpips)
    del unet, clip, lpips
    clear_model_cache()  # the next phase reads the converted caches, not the kept models

    phase("cache_hit")
    if dry_run:
        done("cache_hit", skipped="random mode has no cache files")
    else:
        t0 = time.time()
        resolve_unet(64, True, mode, device=dev, checkpoints_dir=checkpoints_dir)
        resolve_clip("ViT-B/32", mode, dev, checkpoints_dir)
        resolve_lpips(mode, dev, checkpoints_dir)
        dt = time.time() - t0
        npz = _converted_path(os.path.join(checkpoints_dir,
                                           DIFFUSION_LOOKUP["cond"][64]["filename"]))
        if not os.path.exists(npz):
            raise RuntimeError(f"convert-once cache missing: {npz}")
        done("cache_hit", reload_seconds=round(dt, 1))

    phase("acceptance_config_1")
    frames = [path for _b, path in api.clip_guided_diffusion(
        prompts=[PROMPT], image_size=64, timestep_respacing="ddim25",
        clip_model_name="ViT-B/32", num_cutouts=2 if dry_run else 16, batch_size=1,
        save_frequency=5, seed=7, checkpoints_dir=checkpoints_dir, prefix_path=out,
        weights_mode=mode, progress=False, device=str(dev))]
    if not frames:
        raise RuntimeError("config 1 produced no frames")
    done("acceptance_config_1", frames=len(frames), last=frames[-1])

    phase("clip_score")
    cmd = [sys.executable, "-m", "cgd_tpu_torch.tools.clip_score", "--prompt", PROMPT,
           "--weights-mode", mode, "--device", str(dev), "--checkpoints-dir", checkpoints_dir,
           frames[-1]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if res.returncode != 0:
        raise RuntimeError(f"clip_score failed: {res.stderr[-2000:]}")
    score = json.loads(res.stdout.strip().splitlines()[-1])
    done("clip_score", **score)

    report["parity_table"] = {
        "config": "BASELINE config 1 (64px cosine ddim25 ViT-B/32)",
        "prompt": PROMPT,
        "cgd_tpu_torch_clip_score": score,
        "torch_reference_clip_score": (
            "RUN: python -m cgd_tpu_torch.tools.clip_score --prompt '...' "
            "<reference_out>/*.png after generating with the torch reference at the same "
            "config/seed"),
    }
    os.makedirs(out, exist_ok=True)
    out_json = os.path.join(out, "first_real_run_report.json")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nreport: {out_json}")
    print(json.dumps(report["parity_table"], indent=2))
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="no network: random toy weights, the same code paths")
    ap.add_argument("--out", default="./first_real_run_out")
    ap.add_argument("--checkpoints-dir", default=CACHE_PATH)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(args.dry_run, args.out, args.checkpoints_dir, args.device)


if __name__ == "__main__":
    main()
