"""Where the host's time goes, from the port's spans (``utils/tracing.py``),
and where the device waits on it, from a trace that has both.

    python -m cgd_tpu_torch.cli --prompts x -respace ddim25 --profile prof ...
    python -m cgd_tpu_torch.tools.span_report prof/trace.json

Reads the Chrome trace that the CLI's ``--profile`` writes (torch.profiler's
events and the spans on a row of their own, one clock) and prints one JSON
object: each span name's count, total and median ms; the guided step's
split (the median ms a step of each ``step.*`` phase and of the step's own
remainder) and, beside it, the CLIP image tower's share of
``step.guidance`` (``clip_ms_per_step``); the weights read's GB/s; the
reductions below over the whole trace; and, where the trace holds device
operations, the device's idle seconds by the innermost span open at the
time on the request's thread ("no span" where none is; ``guidance.clip``
where the tower's launches were being made).

The reductions take spans as ``tracing.Span`` objects or their ``as_dict()``
and device operations as ``(start_ns, end_ns)`` on the same clock; ``lo`` /
``hi`` bound the window in ns. Each returns None when it has nothing to read:

- ``weights_load_ms``: the median over the requests begun in the window of
  their ``api.models`` span;
- ``models_hit_share``: the share of the models those ``api.models`` spans
  resolved that came from the model cache (their ``hits`` over ``hits`` and
  ``misses``); in a process that calls the API n times with the same
  checkpoint files, (n - 1) / n;
- ``step_host_ms``: the median over the window's guided eager ``step``
  spans (``graph`` 0: a replayed step's span times one graph launch;
  those overlapping ``outside``, a profiled stretch, left out) of their
  host duration; the step's phase split and ``clip_ms_per_step`` read the
  same steps;
- ``replayed_share``: the share of the window's ``step`` spans that
  replayed a CUDA graph (``graph`` 1);
- ``capture_ms``: the median over the window's ``step.capture`` spans of
  their duration;
- ``frame_write_ms``: the median over the window's save points of the
  summed ``images.write`` spans of that save point (``images.to_host``,
  which waits for the device's queued work, left out);
- ``idle_in_step_pct``: the share of ``[lo, hi]`` in which no device
  operation runs while the host is inside a ``step`` span.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from cgd_tpu_torch.utils.tracing import Span

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PHASES = ("step.unet", "step.guidance", "step.backward", "step.update")


def as_dicts(spans) -> List[Dict]:
    return [s.as_dict() if isinstance(s, Span) else s for s in spans]


def _ms(d: Dict) -> float:
    return (d["end_ns"] - d["start_ns"]) / 1e6


def _in(d: Dict, lo: Optional[int], hi: Optional[int]) -> bool:
    return (lo is None or d["start_ns"] >= lo) and (hi is None or d["start_ns"] < hi)


def _median(xs: List[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clip(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def idle(device: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The pieces of ``[lo, hi]`` in which no device operation runs."""
    out, t = [], lo
    for a, b in _clip(union(device), lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def _overlap(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans, thread=None) -> List[Tuple[int, int, str]]:
    """The spans (of one ``thread``, or all) as disjoint pieces ``(start_ns,
    end_ns, name)``, each named by the innermost span open there: the
    latest begun of those that cover it."""
    ds = [d for d in as_dicts(spans) if thread is None or d["thread"] == thread]
    bounds = sorted({t for d in ds for t in (d["start_ns"], d["end_ns"])})
    by_start = sorted(ds, key=lambda d: (d["start_ns"], -d["end_ns"]))
    out: List[Tuple[int, int, str]] = []
    j, open_ = 0, []
    for a, b in zip(bounds, bounds[1:]):
        while j < len(by_start) and by_start[j]["start_ns"] <= a:
            open_.append(by_start[j])
            j += 1
        open_ = [d for d in open_ if d["end_ns"] > a]
        if not open_:
            continue
        name = open_[-1]["name"]
        if out and out[-1][1] == a and out[-1][2] == name:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def _models(spans, lo=None, hi=None) -> List[Dict]:
    """The ``api.models`` spans of the requests begun in the window."""
    ds = as_dicts(spans)
    begun = {d["id"] for d in ds if d["name"] == "api.request" and _in(d, lo, hi)}
    return [d for d in ds if d["name"] == "api.models" and d["parent"] in begun]


def weights_load_ms(spans, lo=None, hi=None) -> Optional[float]:
    return _median([_ms(d) for d in _models(spans, lo, hi)])


def models_hit_share(spans, lo=None, hi=None) -> Optional[float]:
    ds = _models(spans, lo, hi)
    hits = sum(d["counts"].get("hits", 0) for d in ds)
    resolved = hits + sum(d["counts"].get("misses", 0) for d in ds)
    return hits / resolved if resolved else None


def _steps(spans, lo=None, hi=None, outside=None) -> List[Dict]:
    """The guided eager ``step`` spans begun in the window and not
    overlapping ``outside`` (start_ns, end_ns)."""
    out = []
    for d in as_dicts(spans):
        c = d["counts"]
        if d["name"] != "step" or not c.get("guided") or c.get("graph") or not _in(d, lo, hi):
            continue
        if outside is not None and d["end_ns"] > outside[0] and d["start_ns"] < outside[1]:
            continue
        out.append(d)
    return out


def step_host_ms(spans, lo=None, hi=None, outside=None) -> Optional[float]:
    return _median([_ms(d) for d in _steps(spans, lo, hi, outside)])


def replayed_share(spans, lo=None, hi=None) -> Optional[float]:
    steps = [d for d in as_dicts(spans) if d["name"] == "step" and _in(d, lo, hi)]
    return sum(bool(d["counts"].get("graph")) for d in steps) / len(steps) if steps else None


def capture_ms(spans, lo=None, hi=None) -> Optional[float]:
    return _median([_ms(d) for d in as_dicts(spans)
                    if d["name"] == "step.capture" and _in(d, lo, hi)])


def step_phases_ms(spans, lo=None, hi=None, outside=None) -> Dict[str, Optional[float]]:
    """The median ms a guided step of each ``step.*`` phase, and of the
    step's own time outside them (``step.self``)."""
    ds = as_dicts(spans)
    steps = {d["id"]: d for d in _steps(ds, lo, hi, outside)}
    per: Dict[int, Dict[str, float]] = {i: defaultdict(float) for i in steps}
    for d in ds:
        if d["parent"] in per and d["name"] in PHASES:
            per[d["parent"]][d["name"]] += _ms(d)
    out = {p: _median([per[i][p] for i in steps]) for p in PHASES}
    out["step.self"] = _median([_ms(steps[i]) - sum(per[i].values()) for i in steps])
    return out


def clip_ms_per_step(spans, lo=None, hi=None, outside=None) -> Optional[float]:
    """The median ms a guided step of its ``guidance.clip`` spans (the
    image tower's forward over the cutouts), over the steps that open one."""
    ds = as_dicts(spans)
    steps = {d["id"] for d in _steps(ds, lo, hi, outside)}
    parent = {d["id"]: d["parent"] for d in ds}
    per: Dict[int, float] = defaultdict(float)
    for d in ds:
        if d["name"] != "guidance.clip":
            continue
        up = d["parent"]
        while up is not None and up not in steps:
            up = parent.get(up)
        if up is not None:
            per[up] += _ms(d)
    return _median(list(per.values()))


def frame_write_ms(spans, lo=None, hi=None) -> Optional[float]:
    points: Dict[tuple, List[Dict]] = defaultdict(list)
    for d in as_dicts(spans):
        if d["name"] == "images.write":
            points[(d["request"], d["counts"].get("k"))].append(d)
    return _median([sum(_ms(d) for d in ws) for ws in points.values()
                    if _in(min(ws, key=lambda d: d["start_ns"]), lo, hi)])


def idle_in_step_pct(spans, device, lo: int, hi: int) -> Optional[float]:
    if hi <= lo or not device:
        return None
    steps = union(_clip([(d["start_ns"], d["end_ns"]) for d in as_dicts(spans)
                         if d["name"] == "step"], lo, hi))
    return 100.0 * _overlap(idle(device, lo, hi), steps) / (hi - lo)


def idle_by_span(spans, device, lo: int, hi: int) -> Dict[str, float]:
    """The device's idle seconds in ``[lo, hi]`` by the innermost span open
    on the request's thread (that of the first ``api.request``), "no span"
    where none is."""
    ds = as_dicts(spans)
    thread = next((d["thread"] for d in ds if d["name"] == "api.request"), None)
    gaps = idle(device, lo, hi)
    out: Dict[str, float] = defaultdict(float)
    covered = i = 0
    for a, b, name in innermost(ds, thread):  # both lists sorted and disjoint
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        ns = _overlap(gaps[i:], [(a, b)])
        if ns:
            out[name] += ns / 1e9
            covered += ns
    out["no span"] = (sum(b - a for a, b in gaps) - covered) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def read_gb_per_s(spans) -> Optional[float]:
    reads = [d for d in as_dicts(spans) if d["name"] == "weights.read"]
    s = sum(_ms(d) for d in reads) / 1e3
    return sum(d["counts"].get("bytes", 0) for d in reads) / 1e9 / s if s > 0 else None


def report(spans, device=(), lo=None, hi=None, outside=None) -> Dict:
    """Everything above over ``[lo, hi]`` (the spans' own extent by
    default)."""
    ds = as_dicts(spans)
    if ds and lo is None:
        lo = min(d["start_ns"] for d in ds)
    if ds and hi is None:
        hi = max(d["end_ns"] for d in ds)
    names: Dict[str, List[float]] = defaultdict(list)
    for d in ds:
        names[d["name"]].append(_ms(d))
    out = {
        "spans": {n: {"count": len(v), "total_ms": sum(v), "median_ms": statistics.median(v)}
                  for n, v in sorted(names.items())},
        "step_phases_ms": step_phases_ms(ds, lo, hi, outside),
        "clip_ms_per_step": clip_ms_per_step(ds, lo, hi, outside),
        "weights_read_gb_per_s": read_gb_per_s(ds),
        "weights_load_ms": weights_load_ms(ds, lo, hi),
        "models_hit_share": models_hit_share(ds, lo, hi),
        "step_host_ms": step_host_ms(ds, lo, hi, outside),
        "replayed_share": replayed_share(ds, lo, hi),
        "capture_ms": capture_ms(ds, lo, hi),
        "frame_write_ms": frame_write_ms(ds, lo, hi),
    }
    if device and ds:
        out["idle_in_step_pct"] = idle_in_step_pct(ds, device, lo, hi)
        out["idle_s_by_span"] = idle_by_span(ds, device, lo, hi)
    return out


def from_chrome_trace(trace: Dict) -> Tuple[List[Dict], List[Tuple[int, int]]]:
    """(spans, device operations) of a trace the CLI's ``--profile`` wrote,
    in ns on the spans' clock."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    spans, device = [], []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        a = base + round(e["ts"] * 1e3)
        b = a + round(e.get("dur", 0) * 1e3)
        if e.get("cat") == "cgd_span":
            args = dict(e["args"])
            ids = {k: args.pop(k) for k in ("id", "parent", "request")}
            spans.append(dict(name=e["name"], thread=e["tid"], start_ns=a, end_ns=b,
                              counts=args, **ids))
        elif e.get("cat") in DEVICE_CATS:
            device.append((a, b))
    return spans, device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a trace.json written by cgd_tpu_torch.cli --profile DIR")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        spans, device = from_chrome_trace(json.load(f))
    if not spans:
        print(f"{args.trace}: no spans", file=sys.stderr)
        return 1
    print(json.dumps(report(spans, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
