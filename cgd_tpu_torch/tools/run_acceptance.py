"""Run BASELINE.md's acceptance configurations 2-5 end to end through the
port's CLI on the card: the counterpart of ``tools/run_acceptance.py``.

    python -m cgd_tpu_torch.tools.run_acceptance [--only KEY ...] [--out FILE] [--outdir DIR]

  2. 128px, respace 250, ViT-B/16, weighted multi-prompt
  3. 256px, ddim250, init_image + skip 125 + VGG init_scale 1000
  4. 512px, respace 1000, RN50x16, cgs 1500 + tv 150
  5. 256px non-square (width_offset 32), --reduce-clip, MP4 export

Config 1 (64px ddim25) runs in the tests and the CLI smoke command. No
checkpoint is reachable (no network), so every run takes ``--weights-mode
random``: the same architectures, shapes and kernels as the published
weights, meaningless pixels. Each config runs as a fresh ``python -m
cgd_tpu_torch.cli`` process; the init image is written without Pillow
(``io_utils/images.py``). Writes one JSON line per config to ``--out``
(appended) and a table to stdout; exits 1 if any config failed. The
defaults write under ``outputs/`` (the JAX tool's are under ``/tmp``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from cgd_tpu_torch.io_utils.images import encode_png

REPO = Path(__file__).resolve().parents[2]

# the JAX tool's configs, argv for argv (tests/test_torch_port_acceptance.py
# pins them to tools/run_acceptance.py)
CONFIGS = {
    "cfg2_128_multiprompt": dict(
        desc="128px respace 250, ViT-B/16, weighted multi-prompt",
        steps=250,
        argv=[
            "-txts", "an impressionist painting of a lighthouse at dawn:1.0"
                     "|oil on canvas:0.1|blurry:-0.1",
            "-size", "128", "-respace", "250", "-clip", "ViT-B/16",
            "-freq", "50",
        ],
    ),
    "cfg3_256_init_vgg": dict(
        desc="256px ddim250, init_image + skip 125 + VGG init_scale 1000",
        steps=125,
        init_image=True,
        argv=[
            "-txts", "a watercolor seascape",
            "-size", "256", "-respace", "ddim250",
            "-skip", "125", "-is", "1000", "-freq", "25",
        ],
    ),
    "cfg4_512_rn50x16": dict(
        desc="512px respace 1000, RN50x16, cgs 1500 tv 150",
        steps=1000,
        argv=[
            "-txts", "a detailed matte painting of a castle",
            "-size", "512", "-respace", "1000", "-clip", "RN50x16",
            "-cgs", "1500", "-tvs", "150", "-freq", "200",
        ],
    ),
    "cfg5_256_nonsquare_reduce_mp4": dict(
        desc="256px width_offset 32, --reduce-clip, MP4 export",
        steps=250,
        argv=[
            "-txts", "a panoramic photo of mountains",
            "-size", "256", "-respace", "ddim250", "-wd", "32",
            "-reduce", "-mp4", "-freq", "25",
        ],
    ),
}


def make_init_image(path: Path, size: int = 256) -> None:
    """The JAX tool's init image (a smooth gradient and a blob), as an
    8-bit PNG written by the package's own encoder."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    r = np.exp(-(((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.06))
    img = np.stack([0.2 + 0.6 * xx + 0.3 * r, 0.3 + 0.4 * yy + 0.2 * r, 0.5 + 0.4 * r], -1)
    path.write_bytes(encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8)))


def run_config(key: str, cfg: dict, outdir: Path, init_path: Path, timeout: float = 3600) -> dict:
    """Run one config in a fresh CLI process; its JSON record."""
    rundir = outdir / key
    rundir.mkdir(parents=True, exist_ok=True)
    argv = [sys.executable, "-m", "cgd_tpu_torch.cli", *cfg["argv"],
            "--weights-mode", "random", "-q", "-dir", str(rundir)]
    if cfg.get("init_image"):
        argv += ["-init", str(init_path)]
    print(f"== {key}: {cfg['desc']}", flush=True)
    print("   " + " ".join(argv[2:]), flush=True)
    t0 = time.time()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.time() - t0
    frames = sorted(str(p.relative_to(rundir)) for p in rundir.rglob("*.png"))
    videos = sorted(str(p.relative_to(rundir)) for p in rundir.rglob("*.mp4"))
    rec = {
        "config": key, "desc": cfg["desc"], "rc": proc.returncode,
        "wall_s": round(wall, 1), "steps": cfg["steps"],
        "s_per_step_incl_compile": round(wall / cfg["steps"], 3),
        "frames": len(frames), "videos": videos,
        "dir": str(rundir),
        "last_frame": frames[-1] if frames else None,
    }
    if proc.returncode != 0:
        rec["stderr_tail"] = proc.stderr[-2000:]
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, help="subset of config keys")
    ap.add_argument("--out", default="outputs/acceptance.jsonl")
    ap.add_argument("--outdir", default="outputs/acceptance_runs")
    args = ap.parse_args(argv)

    outdir = Path(args.outdir).resolve()
    outdir.mkdir(parents=True, exist_ok=True)
    init_path = outdir / "init_256.png"
    if not init_path.exists():
        make_init_image(init_path)

    results = []
    for key, cfg in CONFIGS.items():
        if args.only and key not in args.only:
            continue
        rec = run_config(key, cfg, outdir, init_path)
        results.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")

    print("\n| config | wall (s) | steps | frames | rc |")
    print("|---|---|---|---|---|")
    for r in results:
        print(f"| {r['config']} | {r['wall_s']} | {r['steps']} | {r['frames']} | {r['rc']} |")
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
