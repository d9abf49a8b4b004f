"""The profiled stretch of a traced run: ``torch.profiler`` over the card's
activity alone (host-side tracing of every operator would slow the
host-bound step it measures, and stretch its idle gaps), reduced to the
device operations (name, start, end in the profiler's microseconds), the
device's busy time (the union of their intervals), and the breakdown the
result carries: the ten device operations that took most time, and the
ten longest idle gaps of the device, each named by what the host was doing:
"host: frame write" where a saved frame came in the gap (the frame's copy
to the host, its PNG encode and writes), else "host: dispatch" (the Python
and launches between two device operations)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile

TOP = 10
NAME_CHARS = 160


def start(cuda: bool):
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    prof.start()
    return prof


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(kernels, saves_us: List[float], wall_s: float, steps: int) -> Dict:
    """``kernels``: [(name, start_us, end_us)]; ``saves_us``: when the saved
    frames came, on the same clock."""
    busy = union([(a, b) for _, a, b in kernels])
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in kernels:
        by_name[name[:NAME_CHARS]] += (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    saves = sorted(saves_us)
    gaps = []
    for (_, a_end), (b_start, _) in zip(busy, busy[1:]):
        i = bisect.bisect_left(saves, a_end)
        frame = i < len(saves) and saves[i] <= b_start
        gaps.append(("host: frame write" if frame else "host: dispatch", (b_start - a_end) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"kernels": kernels, "busy_s": busy_s, "wall_s": wall_s, "steps": steps,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": [[n, s] for n, s in gaps[:TOP]]}}


def read(prof, wall_s: float, steps: int, saves_s: List[float]) -> Dict:
    """``saves_s``: the saved frames' times in seconds from the profiler's
    start."""
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = [(e.name, float(e.time_range.start), float(e.time_range.end))
               for e in prof.events() if e.device_type == cuda_type]
    return summarize(kernels, [t * 1e6 for t in saves_s], wall_s, steps)
