"""The readings the correctness limits of a cell are set from, many seeds in
one process (the benchmark's own runs never run this):

    python3 bench_h100/calibrate.py --workload cog256 --seeds 11-22 \
        [--control 11-14] [--faults clip_loss,clip_layer --fault-seeds 11-13]

For each seed it runs the cell as a run does (``window.run``; the window
closes at the second frame, and the check waits for the frames it
compares) and prints one JSON line: ``program``, the numbers the run's
check compared, each ``frame_mad_s<step>`` (the lower readings), and
``correct``. For the ``--control`` seeds, ``control``: the same numbers
for the reference computed with fp8 operands against the float32
reference, on the request the check compares (the upper readings). For
the ``--fault-seeds``, each fault of ``--faults`` planted in the program's
input alone, the reference left as it is, and the run's numbers:

- ``clip_loss``: the program's calls with ``clip_guidance_scale`` 0;
- ``clip_layer``: one matrix of the CLIP image tower, the middle one, zeroed
  in the program's weight cache, as a layer's kernel that writes nothing;
- ``clip_layer_1.1``: the same matrix times 1.1, a fault of the size that
  the comparison cannot tell from rounding;
- ``lpips_layer``: the middle conv of the LPIPS VGG zeroed in the program's
  weight cache.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = {"clip_loss": None, "clip_layer": ("clip", "visual.", 0.0),
          "clip_layer_1.1": ("clip", "visual.", 1.1), "lpips_layer": ("lpips", "features.", 0.0)}


def seeds(spec: str):
    out = []
    for part in filter(None, spec.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


@contextlib.contextmanager
def planted(fault: str):
    """The fault in the program's input alone: its calls or its caches."""
    from bench_h100.harness import window
    from cgd_tpu_torch import api

    saved = api.clip_guided_diffusion, window.wmod.write_caches
    if fault == "clip_loss":
        call = api.clip_guided_diffusion
        api.clip_guided_diffusion = lambda **kw: call(**dict(kw, clip_guidance_scale=0))
    else:
        kind, key, factor = FAULTS[fault]
        write = window.wmod.write_caches

        def tampered(config, weights, checkpoints_dir):
            sd = dict(weights[kind])
            names = [n for n in sd if n.startswith(key) and sd[n].ndim >= 2]
            name = names[len(names) // 2]
            sd[name] = (sd[name].astype(np.float32) * factor).astype(sd[name].dtype)
            print(f"[fault] {fault}: {kind} {name} times {factor}", file=sys.stderr, flush=True)
            return write(config, dict(weights, **{kind: sd}), checkpoints_dir)

        window.wmod.write_caches = tampered
    try:
        yield
    finally:
        api.clip_guided_diffusion, window.wmod.write_caches = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 11-22 or 5,7,9")
    ap.add_argument("--control", default="", help="the seeds to read the control on")
    ap.add_argument("--faults", default="", help=f"of {sorted(FAULTS)}, comma-separated")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    run_dir = os.path.join(tempfile.gettempdir(), "bench_h100_calibrate")
    from bench_h100 import run as runmod

    runmod.environment(run_dir)
    import torch

    from bench_h100.harness import cells, window
    from bench_h100.reference.sampling import Reference, compare

    class Cell(cells.Cell):  # the window closes at the second frame
        def __init__(self, root, workload):
            super().__init__(root, workload)
            self.traffic["window"] = dict(self.traffic.get("window", {}), close="frame")

    window.Cell = Cell
    cell = Cell(ROOT, args.workload)
    steps = cell.traffic["check"]["steps"]
    dev = torch.device("cuda")
    control, fault_seeds = set(seeds(args.control)), set(seeds(args.fault_seeds))
    faults = [f for f in args.faults.split(",") if f]

    def one(seed):
        window.clear(run_dir)
        os.makedirs(run_dir)
        os.chdir(run_dir)
        try:
            res = window.run(ROOT, args.workload, seed, 0.0, False, run_dir,
                             time.perf_counter())
        finally:
            os.chdir(ROOT)
        return res

    for seed in seeds(args.seeds):
        t = time.perf_counter()
        res = one(seed)
        out = {"seed": seed, "correct": res["correct"], "failed": res["failed"],
               "program": {k: v["value"] for k, v in res["checked"].items()}}
        if seed in control:
            weights, bpe, init_image = window.inputs(cell, seed, run_dir, dev)
            call = next(window.request_calls(cell, seed, run_dir, init_image))
            rw = window.reference_weights(weights)
            want = dict(Reference(cell.config, rw, dev, "float32", bpe).frames(call, max(steps)))
            got = dict(Reference(cell.config, rw, dev, "fp8", bpe).frames(call, max(steps)))
            out["control"] = {f"frame_mad_s{s}": max(compare(g, w) for g, w in zip(got[s], want[s]))
                              for s in steps}
            del weights, rw
        if seed in fault_seeds:
            for fault in faults:
                with planted(fault):
                    res = one(seed)
                out[fault] = {k: v["value"] for k, v in res["checked"].items()}
        out["seconds"] = round(time.perf_counter() - t, 3)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    window.clear(run_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
