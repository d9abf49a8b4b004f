"""The attention kernels on the card against ``F.scaled_dot_product_attention``
(SDPA): device time, host time and eager time per call.

    python cgd_tpu_torch/tools/attn_bench.py [--root DIR] [--dtype float32]

At the shapes ``chip_smoke.py`` phase 3 holds the kernels to ((N heads, T,
d) of batch 1: the UNets' d = 64 levels, then the 128px model's head dims),
it prints for K-attn-f, K-attn-b, SDPA's forward and SDPA's backward:

- device ms per call: the durations of the kernels the call launches (and
  their count), summed under ``torch.profiler`` over 20 calls;
- host us per call: the host's wall clock over 100 calls that nothing waits
  for (the device runs behind), i.e. what a call costs the host;
- eager ms per call: CUDA events around 20 calls in a row, which measure the
  larger of the two.

Every device reading is held against the same call's CUDA-event time with
the calls queued back to back behind a device-side wait
(``checked_device_ms``, ``queued_ms``): one that falls far under it is
measured again in a fresh process, and marked ``*`` if it still does
("fresh" marks a fresh process's reading that holds).

``--root DIR`` imports ``cgd_tpu_torch`` from DIR, a checkout of another
commit, so that two commits compare in one call on one card. ``--dtype
float32`` runs the f32 kernels (K-attn-f f32, K-attn-b f32) and SDPA at f32
(cuBLAS's TF32 off) instead of bf16. Needs a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

SHAPES = [(8, 1024, 64), (16, 256, 64), (16, 64, 64), (4, 1024, 128), (4, 256, 192),
          (4, 64, 256)]


def device_ms(fn, iters: int = 20):
    """(device ms per call, kernels per call) of ``fn`` under torch.profiler.
    A window in which the profiler recorded no kernel (seen once on the
    card, for SDPA), or a count of kernels that is no whole multiple of the
    calls (records dropped: seen on the card late in a long process, the
    summed device time then about half the CUDA events' time), is measured
    again, up to three times. If every window dropped records, the last one
    gives each kernel's mean recorded duration times its launches per call
    (its records over the calls, rounded up: right while fewer than one
    launch per call of a kernel is lost), with the fractional count telling
    of the drop; with no kernel recorded in any window (seen on the card
    late in a long process) it returns (nan, 0.0): not measured."""
    import math
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    last = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            continue
        if len(events) % iters == 0:
            return sum(e.device_time_total for e in events) / 1e3 / iters, len(events) / iters
        last = events
    if last is None:
        return float("nan"), 0.0
    by_name = defaultdict(list)
    for e in last:
        by_name[e.name].append(e.device_time_total)
    ms = sum(sum(t) / len(t) * math.ceil(len(t) / iters) for t in by_name.values()) / 1e3
    return ms, len(last) / iters


def host_us(fn, iters: int = 100) -> float:
    """Host microseconds per call of ``fn``, not waiting for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def eager_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20, host: float = None) -> float:
    """CUDA-event ms per call of ``fn`` with the calls queued behind a
    device-side wait (``torch.cuda._sleep`` for twice the host's time to
    enqueue them, ``host``: us per call), so that they run back to back on
    the device whatever the host's pace: the kernels' time and the gaps
    between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    host = host_us(fn, iters) if host is None else host
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2e6, 2 * iters * host * 2e3)))  # ~2e3 cycles an us
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def suspect(device: float, queued: float) -> bool:
    """A device reading that cannot be the call's: under 0.7 of the same
    call's CUDA-event time with the calls queued back to back
    (``queued_ms``: the kernels plus the gaps between them), so the profiler
    lost some of its records. Seen on the card late in a long process:
    K-attn-b f32 (4, 1024, 128) read 0.1404 ms against 0.2989 ms by events.
    A nan reading (nothing recorded) is suspect too."""
    return not device >= 0.7 * queued


def checked_device_ms(fn, fresh=None, iters: int = 20):
    """(device ms, kernels per call, mark, queued ms, host us) of ``fn``: its
    ``device_ms`` held against its ``queued_ms``. A ``suspect`` reading is
    measured again by ``fresh`` (a callable returning (device ms, kernels
    per call) from a fresh process: ``fresh_ms``), if given; mark is "" for
    a reading that holds, "fresh" for a fresh process's that holds, "*" for
    one that still falls far under the events (the row is marked)."""
    dms, kernels = device_ms(fn, iters)
    host = host_us(fn, iters)
    queued = queued_ms(fn, iters, host)
    mark = ""
    if suspect(dms, queued):
        if fresh is not None:
            dms, kernels = fresh()
        mark = "*" if suspect(dms, queued) else "fresh"
    return dms, kernels, mark, queued, host


def fresh_ms(script: str, root: str, one: str, *extra: str):
    """(device ms, kernels per call) of one call measured by ``script``
    (this file or conv_bench.py) in a new process: ``--one ONE --json``,
    the package imported from ``root``."""
    import json
    import subprocess

    out = subprocess.run([sys.executable, script, "--root", root, "--one", one, "--json",
                          *extra], capture_output=True, text=True, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    return got["device_ms"], got["kernels"]


def measure(fn, fresh=None) -> dict:
    dms, kernels, mark, _, host = checked_device_ms(fn, fresh)
    return {"device_ms": dms, "kernels": kernels, "mark": mark, "host_us": host,
            "eager_ms": eager_ms(fn)}


def calls(kattn, n: int, t: int, d: int, dev, dtype):
    """The four calls at (n, t, d) in ``dtype``: K-attn-f, K-attn-b, SDPA
    forward, SDPA backward (its kernels alone: ``autograd.grad`` of a kept
    graph), on the same q, k, v and cotangent."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(dev).manual_seed(4321)
    qkv = torch.randn(1, t, 3 * n * d, generator=gen, device=dev).to(dtype)
    g = torch.randn(1, t, n * d, generator=gen, device=dev).to(dtype)
    out, lse = kattn.attention_fwd(qkv, n)
    q4, k4, v4, g4 = (z[None].contiguous() for z in (*kattn.split_heads(qkv, n),
                                                     kattn.to_heads(g, n)))
    sq, sk, sv = (z.detach().requires_grad_(True) for z in (q4, k4, v4))
    so = F.scaled_dot_product_attention(sq, sk, sv)
    return {
        "K-attn-f": lambda: kattn.attention_fwd(qkv, n),
        "K-attn-b": lambda: kattn.attention_bwd(qkv, out, lse, g, n),
        "SDPA fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4),
        "SDPA bwd": lambda: torch.autograd.grad(so, (sq, sk, sv), g4, retain_graph=True),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="import cgd_tpu_torch from this checkout (default: this one)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="the kernels' operand type (float32: K-attn-f / K-attn-b f32)")
    p.add_argument("--one", default=None,
                   help="N,T,D,CALL: time that one call alone (a fresh process's reading)")
    p.add_argument("--json", action="store_true", help="with --one: print its device time as JSON")
    args = p.parse_args(argv)
    root = args.root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    import json
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attn_bench: needs a CUDA card")
    from cgd_tpu_torch.kernels import attention as kattn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dtype = torch.device("cuda", 0), getattr(torch, args.dtype)
    if args.one:
        n, t, d, name = args.one.split(",", 3)
        dms, kernels = device_ms(calls(kattn, int(n), int(t), int(d), dev, dtype)[name])
        print(json.dumps({"device_ms": dms, "kernels": kernels}) if args.json else dms)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"cgd_tpu_torch from {kattn.__file__}, {args.dtype}")
    for n, t, d in SHAPES:
        for name, fn in calls(kattn, n, t, d, dev, dtype).items():
            def fresh(one=f"{n},{t},{d},{name}"):
                return fresh_ms(__file__, root, one, "--dtype", args.dtype)

            m = measure(fn, fresh)
            print(f"({n}, {t}, {d}) {name}: device {m['device_ms']:.4f} ms{m['mark']} in "
                  f"{m['kernels']:g} kernels, host {m['host_us']:.1f} us, eager "
                  f"{m['eager_ms']:.4f} ms")


if __name__ == "__main__":
    main()
