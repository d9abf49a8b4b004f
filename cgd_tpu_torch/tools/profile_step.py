"""Where a guided step's time goes on the card: ``torch.profiler`` over a
window of guided steps of the API's sampling loop.

    python -m cgd_tpu_torch.tools.profile_step                 # 256px, ViT-B/32
    python -m cgd_tpu_torch.tools.profile_step --mesh-cut 2    # split cut=2 on one card
    python -m cgd_tpu_torch.tools.profile_step --size 128      # the 128px model (d = 128-256)
    python -m cgd_tpu_torch.tools.profile_step --size 64 --augs  # the 64px model, augmented cutouts
    python -m cgd_tpu_torch.tools.profile_step --fast-guidance # no UNet backward
    python -m cgd_tpu_torch.tools.profile_step --dpm-solver    # the DPM-Solver++(2M) update
    python -m cgd_tpu_torch.tools.profile_step --init          # init image + LPIPS + image prompt
    python -m cgd_tpu_torch.tools.profile_step --compute-dtype float32  # UNet, CLIP, glue in f32

Runs a ddim25 guided sample (random weights, 16 cutouts, batch 1, bf16 or
``--compute-dtype float32``),
times the five guided steps between the frames at steps 5 and 10 with the
profiler off (host clock, synchronised), and profiles the five steps from
10 to 15 (each window includes one frame's PNG write). Prints, per guided
step: the wall time, the device time of all kernels (busy) and the idle
share of the wall time, the device operations, the device time of the
hand-written kernels (``cgd::``), the kernels that take the most device
time, every hand-written kernel template with its device time and
launches, and the attention's device time by head dim. ``--init`` adds the
init-image path (random weights): an init image with skip 5, init_scale
1000 (the LPIPS VGG16 on K-fwd f32) and an image prompt; ``--augs``,
``--fast-guidance`` and ``--dpm-solver`` turn on the API's options of those
names. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from cgd_tpu_torch import api
from cgd_tpu_torch.io_utils.images import encode_png
from cgd_tpu_torch.parallel.mesh import make_mesh

STEPS = 5  # guided steps in the profiled window (frames every 5 steps)
TOP = 12   # kernels listed, by device time


def _kernel_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--clip", default="ViT-B/32")
    p.add_argument("--mesh-cut", type=int, default=0,
                   help="split the run cut=N over N copies of the one card (0: unsplit)")
    p.add_argument("--init", action="store_true",
                   help="init image (skip 5, init_scale 1000) and an image prompt")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--augs", action="store_true", help="augment the guidance cutouts")
    p.add_argument("--fast-guidance", action="store_true",
                   help="guide on a detached denoised prediction (no UNet backward)")
    p.add_argument("--dpm-solver", action="store_true", help="the DPM-Solver++(2M) update")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    mesh = make_mesh([dev] * args.mesh_cut) if args.mesh_cut else None
    init = {}
    if args.init:  # frames at steps 0, 5, 10, 15 of the 20 left after the skip
        out = Path("outputs/profile_step")
        out.mkdir(parents=True, exist_ok=True)
        yy, xx = np.mgrid[0:args.size, 0:args.size] / args.size
        for name, rgb in (("init.png", (xx, yy, xx * yy)), ("style.png", (yy, 1 - xx, xx))):
            (out / name).write_bytes(encode_png((np.stack(rgb, -1) * 255).astype(np.uint8)))
        init = dict(init_image=str(out / "init.png"), skip_timesteps=5, init_scale=1000,
                    image_prompts=[str(out / "style.png")])
    gen = api.clip_guided_diffusion(
        prompts=["a watercolor painting of a lighthouse:1", "fog:0.5"], image_size=args.size,
        num_cutouts=16, clip_model_name=args.clip, timestep_respacing="ddim25",
        weights_mode="random", save_frequency=STEPS, progress=False, mesh=mesh,
        compute_dtype=args.compute_dtype, prefix_path="outputs/profile_step",
        use_augs=args.augs, fast_guidance=args.fast_guidance, dpm_solver=args.dpm_solver, **init)
    next(gen)  # step 0: setup and the first frame
    next(gen)  # step 5: warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    next(gen)  # steps 6-10, unprofiled
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        next(gen)  # steps 11-15
        torch.cuda.synchronize()
    gen.close()

    kernels = _kernel_events(prof)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.device_time_total / 1e3 / STEPS  # ms per step
        by_name[e.name][1] += 1
    busy = sum(t for t, _ in by_name.values())
    mine = sum(t for n, (t, _) in by_name.items() if "cgd::" in n)
    options = "".join(f", {n}" for n in ("augs", "fast_guidance", "dpm_solver") if getattr(args, n))
    label = f"{args.size}px {args.clip}" + (f", mesh cut={args.mesh_cut} on one card"
                                            if args.mesh_cut else "") + (
        ", init image + LPIPS + image prompt" if args.init else "") + f", {args.compute_dtype}" + options
    print(f"{label}: wall {wall * 1e3:.1f} ms per guided step; device busy {busy:.1f} ms "
          f"(idle {1 - busy / (wall * 1e3):.0%}); {len(kernels) / STEPS:.0f} device ops "
          f"(kernels, copies, memsets) per step; hand-written kernels {mine:.1f} ms")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in ranked[:TOP]:
        print(f"  {t:8.3f} ms  {n / STEPS:7.1f}x  {name[:110]}")
    print("hand-written kernels, every template:")
    attn = defaultdict(float)
    for name, (t, n) in ranked:
        if "cgd::" in name:
            print(f"  {t:8.3f} ms  {n / STEPS:7.1f}x  {name[:110]}")
        d = re.search(r"cgd::attn(?:32)?::\w+<(\d+)", name)
        if d:
            attn[int(d.group(1))] += t
    print("attention per step by head dim: " + ", ".join(
        f"d = {d}: {t:.3f} ms" for d, t in sorted(attn.items())) + f"; total {sum(attn.values()):.3f} ms")


if __name__ == "__main__":
    main()
