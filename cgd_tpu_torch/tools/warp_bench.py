"""The augmentation warp's backward on the card: K-warp-b, its index
(K-warp-i where the commit has it), the whole route, and the calls beside
them, at the main path's 16 cutouts of 224^2 and at a draw with long
segments.

    python cgd_tpu_torch/tools/warp_bench.py [--root DIR]

For each draw it prints, per call, the device ms (the durations of the
kernels the call launches, summed under ``torch.profiler`` over 20 calls,
and their count), the eager ms (CUDA events around 20 calls) and the host
us per call (``attn_bench``'s columns), each device reading held against
the same call's CUDA-event time with the calls queued back to back
(``attn_bench.checked_device_ms``; a reading far under it is read again in
a fresh process with ``--one DRAW:CALL --json``, and marked ``*`` if it
still is). The calls:

- ``index``: ``kernels.warp.warp_index`` on the warp ``apply_augs`` built;
- ``index_plain``: ``kernels.warp.warp_index_plain`` on the same warp, run
  on the card (a stable ``torch.sort`` of the bins, a histogram and a scan);
- ``kernel``: ``kernels.warp.warp_bwd`` on that index and a seeded
  cotangent;
- ``route``: the warp's backward as the guided step runs it, autograd
  through ``kernels.warp.bilinear_warp`` on a kept graph (index included);
- ``gather``: autograd's backward of ``kernels.warp.gather_warp`` on the
  same graph (``scatter_add_``, float atomics: what the route replaced);
- ``index_put``: ``index_put_(accumulate=True)`` of the same products
  (the library's sorted scatter);
- ``sort``: ``torch.sort`` of the pairs' bins, stable (the library call an
  index builds on).

``--root DIR`` imports ``cgd_tpu_torch`` from DIR, a checkout of another
commit (a ``git archive`` in a gitignored directory), so that two commits
compare on one card in one call: run parent, change, change, parent, each
in its own process. The calls use only what every commit with the warp's
backward has (``index_plain`` where the commit has it). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

if __package__:
    from . import attn_bench as timing
else:  # run as a script: the sibling file, whatever --root imports
    import attn_bench as timing

PEAK_HBM_BYTES = 3.35e12
DRAWS = ("main", "long")  # 16 cutouts of 224^2 from a seeded draw; long_draw(16, 64)
CALLS = ("index", "index_plain", "kernel", "route", "gather", "index_put", "sort")


def function_bytes(pairs: int, nsrc: int, c: int) -> int:
    """The bytes the warp's backward must move, whatever its index's
    layout: the cotangent g [nsrc, c] f32 and the pairs' weights (f32) and
    output pixels (int32), in segment order, read once; each source pixel's
    segment start (nsrc + 1, int32) read once; the gradient [nsrc, c] f32
    written once. K-warp-b's bound is this over the HBM rate."""
    return 4 * (2 * nsrc * c + 2 * pairs + nsrc + 1)


def long_draw(n: int, size: int, dev):
    """``n`` cutouts' augmentations that give the warp long segments: no
    rotation, the largest translation and perspective the draw allows,
    towards each corner in turn, so the clamped corners collect hundreds
    of pairs a tap."""
    import torch

    from cgd_tpu_torch.guidance import cutouts

    k = torch.arange(n, device=dev)
    sx, sy = 1.0 - 2.0 * (k % 2), 1.0 - 2.0 * (k // 2 % 2)
    lim, no = 0.4 / size, torch.zeros(n, dtype=torch.bool, device=dev)
    return cutouts.AugDraws(flip=k % 3 == 1, angle=torch.zeros(n, device=dev), tx=0.1 * sx,
                            ty=0.1 * sy, persp_on=~no, persp=torch.stack([lim * sx, lim * sy], 1),
                            gray=no, noise=torch.zeros(n, size, size, 3, device=dev))


def warp_inputs(draw: str, dev) -> dict:
    """The warp ``apply_augs`` builds for ``draw`` on seeded cutouts: the
    flipped cutouts x, the taps' source pixels idx and weights, and a
    seeded cotangent g [n * h * w, 3]."""
    import torch

    from cgd_tpu_torch.guidance import cutouts
    from cgd_tpu_torch.kernels import warp

    gen = torch.Generator(dev).manual_seed(16)
    n, size = (16, 224) if draw == "main" else (16, 64)
    cuts = torch.rand(n, size, size, 3, generator=gen, device=dev)
    aug = cutouts.draw_augs(gen, n, size, size, 3) if draw == "main" else long_draw(n, size, dev)
    seen, real = {}, warp.bilinear_warp

    def spy(x, idx, weight):
        seen.update(x=x.detach(), idx=idx, weight=weight)
        return real(x, idx, weight)

    warp.bilinear_warp = spy
    try:
        cutouts.apply_augs(cuts, aug)
    finally:
        warp.bilinear_warp = real
    g = torch.randn(n * size * size, 3, generator=torch.Generator(dev).manual_seed(17), device=dev)
    return dict(seen, g=g, n=n, size=size)


def calls(draw: str, dev) -> dict:
    """The CALLS on ``draw``'s warp, and the inputs they share."""
    import torch

    from cgd_tpu_torch.kernels import warp

    w = warp_inputs(draw, dev)
    x, idx, weight, g, n, size = (w[k] for k in ("x", "idx", "weight", "g", "n", "size"))
    taps, nsrc = idx.shape[0], n * size * size
    index = warp.warp_index(idx, weight)
    g4 = g.reshape(n, size, size, 3)
    xk, xg = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out_k, out_g = warp.bilinear_warp(xk, idx, weight), warp.gather_warp(xg, idx, weight)
    src = (torch.arange(n, device=dev)[:, None] * (size * size)
           + idx.reshape(taps, n, size * size)).reshape(-1)
    bins = (src.reshape(taps, -1) * taps + torch.arange(taps, device=dev)[:, None]).reshape(-1)
    bins = bins.to(torch.int32)

    def index_put():
        vals = (weight.reshape(taps, nsrc, 1) * g).reshape(taps * nsrc, 3)
        return torch.zeros_like(g).index_put_((src,), vals, accumulate=True)

    return {
        "index": lambda: warp.warp_index(idx, weight),
        "index_plain": lambda: warp.warp_index_plain(idx, weight),
        "kernel": lambda: warp.warp_bwd(g, index),
        "route": lambda: torch.autograd.grad(out_k, xk, g4, retain_graph=True),
        "gather": lambda: torch.autograd.grad(out_g, xg, g4, retain_graph=True),
        "index_put": index_put,
        "sort": lambda: torch.sort(bins, stable=True),
        "inputs": dict(w, index=index),
    }


def fresh(root: str, draw: str, call: str):
    """(device ms, kernels per call) of one call in a new process."""
    return timing.fresh_ms(str(Path(__file__).resolve()), root, f"{draw}:{call}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="import cgd_tpu_torch from this checkout (default: this one)")
    p.add_argument("--one", default=None, help="DRAW:CALL: time that one call alone")
    p.add_argument("--json", action="store_true", help="with --one: print its device time as JSON")
    args = p.parse_args(argv)
    root = args.root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("warp_bench: needs a CUDA card")
    from cgd_tpu_torch.kernels import warp

    dev = torch.device("cuda", 0)
    if args.one:
        draw, call = args.one.split(":")
        dms, kernels = timing.device_ms(calls(draw, dev)[call])
        print(json.dumps({"device_ms": dms, "kernels": kernels}) if args.json else dms)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"cgd_tpu_torch from {warp.__file__}")
    for draw in DRAWS:
        fns = calls(draw, dev)
        w = fns["inputs"]
        nbytes = function_bytes(w["idx"].numel(), *w["g"].shape)
        seg = torch.zeros(w["n"] * w["size"] ** 2, device=dev)  # pairs per source pixel
        seg.index_add_(0, (torch.arange(w["n"], device=dev)[:, None] * w["size"] ** 2
                           + w["idx"].reshape(4, w["n"], -1)).reshape(-1),
                       torch.ones(w["idx"].numel(), device=dev))
        print(f"{draw}: {w['n']} cutouts of {w['size']}^2, {w['idx'].numel()} pairs, the longest "
              f"segment {int(seg.max())}, {int((seg > 32).sum())} over 32; the backward's inputs "
              f"and output {nbytes / 1e6:.1f} MB, K-warp-b's bound "
              f"{nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms", flush=True)
        for call in CALLS:
            if call == "index_plain" and not hasattr(warp, "warp_index_plain"):
                continue
            dms, kernels, mark, _, host = timing.checked_device_ms(
                fns[call], lambda c=call: fresh(root, draw, c))
            print(f"  {call}: device {dms:.4f} ms{mark} in {kernels:g} kernels, eager "
                  f"{timing.eager_ms(fns[call]):.4f} ms, host {host:.1f} us", flush=True)


if __name__ == "__main__":
    main()
