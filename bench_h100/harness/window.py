"""One run of one cell: set-up, the measured window through
``cgd_tpu_torch.api.clip_guided_diffusion``, the check against the
reference, the metrics.

The window is a closed loop with one client, as the Cog predictor and the
CLI call the API: one call per request, back to back, every frame consumed.
Set-up runs the first request up to its first saved frame, and the window
opens there. A request that ends inside the window is followed at once by
the next, so its set-up (weights read, models built, prompts encoded) lies
in the window as a deployment pays it. The window closes at the first saved
frame after ``seconds``; where the traffic's ``window.close`` is "request",
at the first frame of a request after ``seconds``, so that it spans whole
periods of set-up and steps, as it opened at request 0's first frame.
Its work is the guided image-steps done in it:
each saved frame at step k of a request marks k + 1 steps of that request
done (times the batch), and a request that ends marks all of its steps. A
request fails where it raises or saves a frame that is all 0 or 255.

With ``trace`` a ``torch.profiler`` stretch covers ``traffic["trace"]``'s
steps of the first request inside the window; the per-layer metrics read it.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from bench_h100.harness import trace as trace_mod
from bench_h100.harness import weights as wmod
from bench_h100.harness.cells import Cell, peak
from bench_h100.reference import png
from bench_h100.reference.sampling import Reference, compare

FORBIDDEN = ("jax", "jaxlib", "flax", "cgd_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def respaced_steps(respacing: str) -> int:
    if respacing.startswith("ddim"):
        return int(respacing[4:])
    return sum(int(c) for c in respacing.split(","))


class Request:
    def __init__(self, idx: int, call: dict):
        self.idx, self.call = idx, call
        self.t_call: Optional[float] = None
        self.marks: List[tuple] = []
        self.saves: List[tuple] = []  # (host time, step, [frame paths])
        self.done_steps = 0
        self.finished = False
        self.error: Optional[str] = None
        self.bad_frame: Optional[str] = None
        self.in_window = False

    def pet(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))

    def phases(self) -> dict:
        """ms from the call to each progress mark's first occurrence."""
        out = {}
        for phase, t in self.marks:
            out.setdefault(phase.split(" (")[0], round((t - self.t_call) * 1e3, 1))
        return out

    @property
    def setup_ms(self) -> Optional[float]:
        for phase, t in self.marks:
            if phase.startswith("compile + first sampling segment"):
                return (t - self.t_call) * 1e3
        return None


def request_calls(cell: Cell, seed: int, run_dir: str, init_image: Optional[str]):
    """The API keyword arguments of request i, for i = 0, 1, ...: the
    traffic's fixed arguments, the request's own seed and prompts."""
    cfg, tr = cell.config, cell.traffic
    phrases = tr["prompts"]["phrases"]
    i = 0
    while True:
        ss = np.random.SeedSequence([seed, 1000 + i])
        req_seed, pick = (int(v) for v in ss.generate_state(2))
        rs = np.random.RandomState(pick)
        prompts = [phrases[j] for j in rs.choice(len(phrases), tr["prompts"]["per_request"],
                                                 replace=False)]
        call = dict(tr["call"], prompts=prompts, seed=req_seed,
                    image_size=cfg["unet"]["image_size"],
                    class_cond=bool(cfg["unet"].get("class_cond")),
                    clip_model_name=cfg["clip"]["name"], compute_dtype=cfg["compute_dtype"],
                    checkpoints_dir=os.path.join(run_dir, "checkpoints"),
                    prefix_path=os.path.join(run_dir, "frames", f"r{i}"))
        if init_image:
            call["init_image"] = init_image
        yield call
        i += 1


def inputs(cell: Cell, seed: int, run_dir: str, dev):
    """The run's inputs from its seed: (published weights, merge table path,
    init image path or None); the files written."""
    cfg, tr = cell.config, cell.traffic
    wseed = int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    weights = wmod.make_weights(cfg, wseed, dev, bool(tr["call"].get("init_scale")))
    words = {w for p in tr["prompts"]["phrases"] for w in p.lower().split()}
    bpe = os.path.join(os.environ["HOME"], ".cache", "clip-guided-diffusion",
                       "bpe_simple_vocab_16e6.txt.gz")
    wmod.write_merge_table(bpe, seed, words)
    init_image = None
    if tr.get("init_image"):
        init_image = os.path.join(run_dir, "init.png")
        wmod.write_init_image(init_image, seed, cfg["unet"]["image_size"])
    return weights, bpe, init_image


def prepare(cell: Cell, seed: int, run_dir: str, dev):
    """``inputs`` and the port's weight caches written from them; the bytes
    of the caches last."""
    weights, bpe, init_image = inputs(cell, seed, run_dir, dev)
    nbytes = wmod.write_caches(cell.config, weights, os.path.join(run_dir, "checkpoints"))
    return weights, bpe, init_image, nbytes


def reference_weights(weights) -> dict:
    return {k: {n: torch.from_numpy(np.asarray(v)) for n, v in sd.items()}
            for k, sd in weights.items()}


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, run_dir: str,
        t_start: float, device: str = "cuda") -> dict:
    """Runs the cell; returns the result object (the last line of output)."""
    from cgd_tpu_torch import api

    cell = Cell(root, workload)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    batch = tr["call"]["batch_size"]
    if cuda:
        log(f"[card] {nvidia_smi()}")

    # ---- the kernels, the inputs ----------------------------------------
    t = time.perf_counter()
    if cuda:
        try:
            from cgd_tpu_torch.kernels import _build
            _build.library()
            log(f"[setup] kernel library ready in {time.perf_counter() - t:.3f} s")
        except (ImportError, AttributeError) as e:
            log(f"[setup] kernel library not built ahead ({e}); the first request builds it")
    t = time.perf_counter()
    weights, bpe, init_image, nbytes = prepare(cell, seed, run_dir, dev)
    log(f"[setup] seeded weights, caches ({nbytes} bytes), merge table in "
        f"{time.perf_counter() - t:.3f} s")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window -----------------------------------------------------
    n_steps = respaced_steps(tr["call"]["timestep_respacing"]) - tr["call"].get("skip_timesteps", 0)
    calls = request_calls(cell, seed, run_dir, init_image)
    requests: List[Request] = []
    st = SimpleNamespace(t_open=None, t_close=None, work=0, saves=[], prof=None,
                         stretch=None, region=None, trace_work=0)
    tcfg = tr.get("trace", {})
    deadline = None
    # "request": close at a request's first frame, the phase the window
    # opened at, so that it spans whole request periods (set-up and steps)
    per_request = tr.get("window", {}).get("close", "frame") == "request"

    def save_point(req: Request, step: int, paths, now: float) -> None:
        req.saves.append((now, step, paths))
        if st.t_open is None:  # the window opens: this frame's steps are set-up's
            st.t_open = now
        else:
            st.work += (step + 1 - req.done_steps) * batch
        req.done_steps = step + 1
        st.saves.append(now)
        if trace and req.idx == 0:
            # the stretch [start, stop] inside the traced region [before the
            # profiler starts, after it has stopped], which the untraced
            # rate leaves out
            if step == tcfg["from_step"] and st.prof is None:
                st.region = [time.perf_counter(), None]
                st.prof = trace_mod.start(cuda)
                st.stretch = [time.perf_counter(), None, st.work]
            elif st.prof is not None and st.stretch[1] is None \
                    and step == tcfg["from_step"] + tcfg["steps"]:
                if cuda:
                    torch.cuda.synchronize(dev)
                st.stretch[1] = time.perf_counter()
                st.trace_work = st.work - st.stretch[2]
                st.prof.stop()
                st.region[1] = time.perf_counter()

    gen = None
    while st.t_close is None:
        req = Request(len(requests), next(calls))
        requests.append(req)
        req.in_window = st.t_open is not None
        req.t_call = time.perf_counter()
        gen = api.clip_guided_diffusion(**req.call, weights_mode="auto", device=device,
                                        progress=False, stall_pet=req.pet)
        paths = []
        try:
            for batch_idx, path in gen:
                paths.append(path)
                if batch_idx != batch - 1:
                    continue
                now = time.perf_counter()
                step = int(os.path.basename(path)[:-4])
                save_point(req, step, paths, now)
                paths = []
                if deadline is None:
                    deadline = st.t_open + seconds
                elif now >= deadline and (not per_request or len(req.saves) == 1):
                    st.t_close = now
                    break
            else:
                req.finished = True
                if st.t_open is not None:
                    st.work += (n_steps - req.done_steps) * batch
                    req.done_steps = n_steps
        except Exception as e:  # a request that fails is counted, and the next one starts
            req.error = f"{type(e).__name__}: {e}"
            log(f"[window] request {req.idx} failed: {req.error}")
            if st.t_open is None:
                raise
            if time.perf_counter() >= deadline:  # no frame came after the time was up
                st.t_close = time.perf_counter()
    steps = tr["check"]["steps"]
    if not any(checkable(r, steps) for r in requests) and not req.finished and not req.error:
        # the frames the check compares are due: wait for the request in
        # flight, a minute at most, outside the window
        t_wait = time.perf_counter()
        for batch_idx, path in gen:
            paths.append(path)
            if batch_idx == batch - 1:
                req.saves.append((time.perf_counter(), int(os.path.basename(path)[:-4]), paths))
                paths = []
                if checkable(req, steps) or time.perf_counter() - t_wait > 60:
                    break
    if gen is not None:
        gen.close()
    del gen
    window_s = st.t_close - st.t_open
    setup_s = st.t_open - t_start
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        log(f"[card] {nvidia_smi()}")
    for r in requests:
        r.bad_frame = degenerate(r)
        if r.bad_frame:
            log(f"[window] request {r.idx} failed: {r.bad_frame}")
    failed = sum(1 for r in requests if r.error or r.bad_frame)
    log(f"[window] {window_s:.6f} s, {st.work} image-steps, {len(st.saves)} saved frames, "
        f"{len(requests)} requests begun ({sum(r.in_window for r in requests)} in the window), "
        f"{failed} failed; set-up {setup_s:.6f} s; max_memory_allocated {mem_peak} bytes")

    # ---- the trace ------------------------------------------------------
    stretch = None
    if trace and st.prof is not None and st.stretch[1] is not None:
        t = time.perf_counter()
        t0 = st.stretch[0]
        saves = [t - t0 for t in st.saves if t0 <= t <= st.stretch[1]]
        stretch = trace_mod.read(st.prof, st.stretch[1] - t0, st.trace_work // batch, saves)
        log(f"[trace] {stretch['steps']} steps, {len(stretch['kernels'])} device ops, wall "
            f"{stretch['wall_s']:.6f} s, busy {stretch['busy_s']:.6f} s; read in "
            f"{time.perf_counter() - t:.1f} s")
        st.prof = None

    # ---- the check ------------------------------------------------------
    checked = check(cell, seed, requests, weights, dev, bpe, batch)
    del weights
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded modules of JAX or the JAX package: {found}")

    # ---- the metrics ----------------------------------------------------
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    region_s = (st.region[1] - st.region[0]) if stretch else 0.0
    ctx = SimpleNamespace(
        cell=cell, config=cfg, traffic=tr, batch=batch, setup_s=setup_s, window_s=window_s,
        work=st.work, untraced_work=st.work - st.trace_work, untraced_s=window_s - region_s,
        gaps_ms=[(b - a) * 1e3 for a, b in zip(st.saves, st.saves[1:])],
        requests=requests, stretch=stretch, device_name=name,
        count=cell.count, peak=lambda key: peak(root, name, key))
    log(f"[samples] {len(ctx.gaps_ms)} frame gaps; request set-ups "
        f"{[round(r.setup_ms, 3) for r in requests if r.in_window and r.setup_ms]} ms; "
        f"their phases {[r.phases() for r in requests if r.in_window]}")
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell.workload["chips"], "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(checked["correct"] and failed == 0), "attempted": len(requests),
              "failed": failed, "metrics": metrics, "device": device_info}
    if stretch:
        device_info["busy_s"] = stretch["busy_s"]
        device_info["window_s"] = stretch["wall_s"]
        result["breakdown"] = stretch["breakdown"]
    result["checked"] = checked["numbers"]
    return result


def degenerate(req: Request) -> Optional[str]:
    """The first frame of the request whose every value is 0 or 255, as a
    non-finite or exploded prediction writes it, or None."""
    for _, step, paths in req.saves:
        for path in paths:
            with open(path, "rb") as f:
                img = png.decode(f.read())
            if np.all((img == 0) | (img == 255)):
                return f"the frame of step {step} ({os.path.basename(path)}) is all 0 or 255"
    return None


def checkable(req: Request, steps) -> bool:
    """Has the request saved every frame the check compares?"""
    return {s for _, s, _ in req.saves} >= set(steps)


def check(cell: Cell, seed: int, requests: List[Request], weights, dev, bpe: str,
          batch: int) -> dict:
    """The reference run over the first steps of requests drawn from the
    seed, against the frames the program saved. For each compared step
    (``check.steps``), ``frame_mad_s<step>``: the largest over the requests'
    images of the mean absolute difference (of the full scale) between the
    program's frame and the reference's, held to its own limit."""
    spec = cell.traffic["check"]
    steps = spec["steps"]
    done = [r for r in requests if checkable(r, steps)]
    rs = np.random.RandomState(np.random.SeedSequence([seed, 3]).generate_state(1)[0])
    chosen = [done[i] for i in sorted(rs.choice(len(done), min(spec["requests"], len(done)),
                                                replace=False))] if done else []
    t = time.perf_counter()
    worst = {s: (0.0 if chosen else math.nan) for s in steps}
    if chosen:
        ref = Reference(cell.config, reference_weights(weights), dev, "float32", bpe)
        for req in chosen:
            want = dict(ref.frames(req.call, max(steps)))
            for _, step, paths in req.saves:
                if step not in worst:
                    continue
                for b, path in enumerate(paths):
                    with open(path, "rb") as f:
                        got = png.decode(f.read())
                    d = compare(got, want[step][b])
                    log(f"[check] request {req.idx} step {step} image {b}: frame_mad {d:.6g}")
                    worst[step] = max(worst[step], d)
        del ref
    numbers, ok = {}, bool(chosen)
    for step in steps:
        name = f"frame_mad_s{step}"
        limit = cell.limits.get(name, {}).get("limit")
        numbers[name] = {"value": worst[step], "limit": limit}
        ok = ok and limit is not None and worst[step] <= limit
    log(f"[check] {len(chosen)} requests against the reference in {time.perf_counter() - t:.1f} s")
    return {"correct": ok, "numbers": numbers}


def clear(run_dir: str) -> None:
    shutil.rmtree(run_dir, ignore_errors=True)
