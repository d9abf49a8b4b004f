"""The f32 conv kernels on the card (K-fwd f32, K-halo f32, K-dx f32) against
cuDNN's f32 conv with TF32 off: device time, eager time and host time per
call, at the shapes of ``PERF.md``'s table.

    python cgd_tpu_torch/tools/conv_bench.py [--root DIR] [--rows SUBSTRING]

For every row it prints the kernel's device ms per call (the durations of
the kernels the call launches, summed under ``torch.profiler`` over 20
calls, and their count), its eager ms (CUDA events around 20 calls) and
host us per call (``attn_bench``'s three columns), then cuDNN's device and
eager ms on the same inputs (the bare conv: K-fwd's on its activated input,
K-halo's on the stacked rows, K-dx's conv of the cotangent alone), the
factor of the two device times, and the row's bound (FLOPs / 495 TFLOP/s
TF32, or bytes / 3.35 TB/s). Each device reading is held against the same
call's CUDA-event time with the calls queued back to back
(``attn_bench.checked_device_ms``): one that falls far under it is measured
again in a fresh process (``--one KEY:CALL --json``) and marked ``*`` if it
still does.

``--root DIR`` imports ``cgd_tpu_torch`` from DIR, a checkout of another
commit (a ``git archive`` in a gitignored directory), so that two commits
compare on one card in one call: run parent, change, change, parent, each
in its own process. The rows call only the public wrappers
(``kernels.conv3x3.conv3x3_fwd`` / ``conv3x3_dx``), which every commit of
the port has. Needs a card.
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

PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

# (key, kind, batch, H, W, Cin, Cout, prologue, skip, up): K-fwd f32 at the
# LPIPS VGG16's shapes and in the UNet's modes (for up, H x W is the output),
# K-halo f32 on one shard (H rows), K-dx f32 (forward Cin -> Cout)
ROWS = [
    ("fwd-vgg-256-3-64", "fwd", 1, 256, 256, 3, 64, False, False, False),
    ("fwd-vgg-64-256-256", "fwd", 1, 64, 64, 256, 256, False, False, False),
    ("fwd-vgg-16-512-512", "fwd", 1, 16, 16, 512, 512, False, False, False),
    ("fwd-256-3-256", "fwd", 1, 256, 256, 3, 256, False, False, False),
    ("fwd-256-256-256-pro-res", "fwd", 1, 256, 256, 256, 256, True, True, False),
    ("fwd-128-512-512-pro-up", "fwd", 1, 128, 128, 512, 512, True, False, True),
    ("fwd-16-2048-1024-pro", "fwd", 1, 16, 16, 2048, 1024, True, False, False),
    ("fwd-256-256-6-pro", "fwd", 1, 256, 256, 256, 6, True, False, False),
    ("halo-128x256-3-256", "halo", 1, 128, 256, 3, 256, False, False, False),
    ("halo-128x256-256-256-gn-res", "halo", 1, 128, 256, 256, 256, True, True, False),
    ("halo-8x16-2048-1024-gn", "halo", 1, 8, 16, 2048, 1024, True, False, False),
    ("halo-256x512-128-128-gn", "halo", 1, 256, 512, 128, 128, True, False, False),
    ("halo-4x8-1024-1024-gn-res", "halo", 1, 4, 8, 1024, 1024, True, True, False),
    ("halo-2x8-1024-1024-gn-res", "halo", 1, 2, 8, 1024, 1024, True, True, False),
    ("dx-256-256-256", "dx", 1, 256, 256, 256, 256, False, False, False),
    ("dx-16-2048-1024", "dx", 1, 16, 16, 2048, 1024, False, False, False),
    ("dx-256-256-6", "dx", 1, 256, 256, 256, 6, False, False, False),
    ("dx-512-256-128", "dx", 1, 512, 512, 256, 128, False, False, False),
]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def build(k3, row, dev) -> dict:
    """The row's calls on seeded inputs: {"kernel": fn, "cudnn": fn}, and
    its FLOPs and bytes (each input read once, each output written once)."""
    import torch
    import torch.nn.functional as F

    key, kind, b, h, w, ci, co, pro, sk, up = row
    gen = torch.Generator(dev).manual_seed(sum(map(ord, key)))

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    flops = 2 * b * h * w * 9 * ci * co
    if kind == "dx":
        x, g = rn(b, h, w, ci), rn(b, h, w, co)
        wt = k3._flip_t(rn(3, 3, ci, co, scale=(9 * ci) ** -0.5))
        A, B = 1.0 + 0.2 * rn(b, ci), 0.2 * rn(b, ci)
        out = k3.conv3x3_dx(g, wt, x, A, B)
        return {"kernel": lambda: k3.conv3x3_dx(g, wt, x, A, B),
                "cudnn": lambda: k3._conv_nhwc(g, wt), "flops": flops,
                "bytes": _nbytes(g, wt, x, A, B, *out)}
    hs, ws = (h // 2, w // 2) if up else (h, w)
    x, wk, bias = rn(b, hs, ws, ci), rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
    A = 1.0 + 0.2 * rn(b, ci) if pro else None
    B = 0.2 * rn(b, ci) if pro else None
    skip = rn(b, h, w, co) if sk else None
    act = x if A is None else k3._silu_chain(x, A, B)[2]
    if kind == "halo":
        etop, ebot = rn(b, 1, w, ci), rn(b, 1, w, ci)
        stacked = torch.cat([etop, act, ebot], dim=1).permute(0, 3, 1, 2)
        w_oihw = wk.permute(3, 2, 0, 1)
        out = k3.conv3x3_fwd(x, wk, bias, A, B, skip, etop=etop, ebot=ebot)
        return {"kernel": lambda: k3.conv3x3_fwd(x, wk, bias, A, B, skip, etop=etop, ebot=ebot),
                "cudnn": lambda: F.conv2d(stacked, w_oihw, padding=(0, 1)), "flops": flops,
                "bytes": _nbytes(x, wk, bias, A, B, skip, etop, ebot, out)}
    act = k3._up2(act) if up else act
    out = k3.conv3x3_fwd(x, wk, bias, A, B, skip, up)
    return {"kernel": lambda: k3.conv3x3_fwd(x, wk, bias, A, B, skip, up),
            "cudnn": lambda: k3._conv_nhwc(act, wk), "flops": flops,
            "bytes": _nbytes(x, wk, bias, A, B, skip, out)}


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "F") if t_ops >= t_bytes else (t_bytes, "B")


def fresh(root: str, key: str, call: str):
    """(device ms, kernels per call) of one row's call in a new process."""
    return timing.fresh_ms(str(Path(__file__).resolve()), root, f"{key}:{call}")


def measure_row(k3, row, dev, root: str) -> dict:
    calls = build(k3, row, dev)
    res = {"key": row[0], "flops": calls["flops"], "bytes": calls["bytes"]}
    for call in ("kernel", "cudnn"):
        dms, kernels, mark, _, host = timing.checked_device_ms(
            calls[call], lambda c=call: fresh(root, row[0], c))
        res[call] = {"device_ms": dms, "kernels": kernels, "mark": mark,
                     "eager_ms": timing.eager_ms(calls[call]), "host_us": host}
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="import cgd_tpu_torch from this checkout (default: this one)")
    p.add_argument("--rows", default="", help="only the rows whose key holds this text")
    p.add_argument("--one", default=None, help="KEY:CALL: time that one call alone")
    p.add_argument("--json", action="store_true", help="with --one: print its device time as JSON")
    args = p.parse_args(argv)
    root = args.root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conv_bench: needs a CUDA card")
    from cgd_tpu_torch.kernels import conv3x3 as k3

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows = {r[0]: r for r in ROWS}
    if args.one:
        key, call = args.one.split(":")
        dms, kernels = timing.device_ms(build(k3, rows[key], dev)[call])
        print(json.dumps({"device_ms": dms, "kernels": kernels}) if args.json else dms)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"cgd_tpu_torch from {k3.__file__}")
    for row in ROWS:
        if args.rows not in row[0]:
            continue
        m = measure_row(k3, row, dev, root)
        kern, lib = m["kernel"], m["cudnn"]
        bd, by = bound_ms(m["flops"], m["bytes"])
        print(f"{row[0]}: device {kern['device_ms']:.4f} ms{kern['mark']} in "
              f"{kern['kernels']:g} kernels, eager {kern['eager_ms']:.4f} ms, host "
              f"{kern['host_us']:.1f} us; cuDNN device {lib['device_ms']:.4f} ms{lib['mark']}, "
              f"eager {lib['eager_ms']:.4f} ms ({kern['device_ms'] / lib['device_ms']:.2f}x); "
              f"bound {bd:.4f} ms {by}, {bd / kern['device_ms']:.1%} of it; "
              f"{m['flops'] / kern['device_ms'] / 1e9:.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
