"""Serving throughput of the port's daemon in two arms: pipelined (the
default) against one lock around each whole request. Counterpart of the
JAX package's ``tools/serve_throughput.py``.

    python -m cgd_tpu_torch.tools.serve_throughput --size 256 --respace ddim250 \\
        --requests 6 --concurrency 2 --arms before,after
    python -m cgd_tpu_torch.tools.serve_throughput --tiny       # toy models on the CPU

The arms:

  after  (the default environment)   one device lock around sampling only:
                                      request N+1's weight resolution,
                                      tokenization and validation overlap
                                      request N's sampling
  before (CGD_TPU_SERVE_PIPELINE=0)  one lock around the whole request

The JAX tool's ``before`` arm also sets ``CGD_TPU_SEG_CACHE=0``, which makes
its daemon trace and compile each request's segments anew; the port has no
counterpart, since eager PyTorch compiles nothing per request.

Each arm: a fresh ``python -m cgd_tpu_torch.serve --weights-mode random``
process on a free port (``--port`` to fix it), wait for ``/healthz``, one
untimed warm request (the kernels' build, the CUDA context), then
``--requests`` timed requests with distinct prompts from ``--concurrency``
closed-loop client threads; every response must be a PNG. The wall runs
from the first request sent to the last response read. One JSON line per
arm (``arm``, ``warm_s``, ``requests``, ``wall_s``, ``s_per_request``,
``req_per_hour``, ``mean_latency_s``), then ``speedup`` (after / before)
when both ran.

``--tiny`` runs the toy models (``CGD_TPU_DEBUG_TINY=1``) on a daemon
started with ``--device cpu``, 64px ddim10 with 2 cutouts unless given, in
f32; without it the daemon runs on the card (and refuses to start without
one).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
ARM_ENV = {"before": {"CGD_TPU_SERVE_PIPELINE": "0"}, "after": {}}
HEALTH_TIMEOUT_S = 120.0  # a daemon's start: imports, the card's context, the kernels' build


def _post(base: str, payload: dict, timeout: float) -> bytes:
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read()
    if data[:8] != PNG_MAGIC:
        raise RuntimeError(f"non-PNG response ({len(data)} bytes)")
    return data


def _wait_healthy(base: str, deadline_s: float, proc) -> None:
    t0 = time.monotonic()
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"daemon exited rc={proc.returncode} before becoming healthy")
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                json.loads(r.read())
                return
        except OSError:
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError("daemon never became healthy") from None
            time.sleep(1.0)


def free_port() -> int:
    """A port the kernel hands out for 0 on localhost, free when asked."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_arm(name: str, payload_base: dict, args) -> dict:
    port = args.port or free_port()
    env = dict(os.environ, **ARM_ENV[name])
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "cgd_tpu_torch.serve", "--port", str(port),
           "--weights-mode", "random"]
    if args.tiny:
        env["CGD_TPU_DEBUG_TINY"] = "1"
        cmd += ["--device", "cpu"]
    log_path = os.path.join(tempfile.gettempdir(), f"serve_tp_{name}_{port}.log")
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=log)
        try:
            _wait_healthy(base, HEALTH_TIMEOUT_S, proc)
            t0 = time.monotonic()
            _post(base, dict(payload_base, prompt=f"warmup {name}"), args.timeout)
            warm_s = time.monotonic() - t0

            prompts = [f"throughput probe {name} {i}" for i in range(args.requests)]
            lat: list = [None] * args.requests
            idx_lock = threading.Lock()
            next_idx = [0]
            errors: list = []

            def worker():
                while True:
                    with idx_lock:
                        i = next_idx[0]
                        if i >= args.requests:
                            return
                        next_idx[0] += 1
                    t = time.monotonic()
                    try:
                        _post(base, dict(payload_base, prompt=prompts[i]), args.timeout)
                    except Exception as e:  # reported below, with the daemon's log
                        errors.append(f"req {i}: {e}")
                        return
                    lat[i] = time.monotonic() - t

            t0 = time.monotonic()
            threads = [threading.Thread(target=worker) for _ in range(args.concurrency)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(args.timeout)
            wall = time.monotonic() - t0
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError("; ".join(errors) or "a client thread did not finish")
            done = [x for x in lat if x is not None]
            return {
                "arm": name, "warm_s": round(warm_s, 1),
                "requests": len(done), "wall_s": round(wall, 1),
                "s_per_request": round(wall / len(done), 2),
                "req_per_hour": round(3600.0 * len(done) / wall, 1),
                "mean_latency_s": round(sum(done) / len(done), 2),
            }
        except Exception:
            print(f"[{name}] daemon log: {log_path}", file=sys.stderr)
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--respace", default="ddim250")
    ap.add_argument("--cutn", type=int, default=16)
    ap.add_argument("--clip", default="ViT-B/32")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--concurrency", type=int, default=2)
    ap.add_argument("--port", type=int, default=0, help="0: a free port for each arm")
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds per request")
    ap.add_argument("--arms", default="before,after")
    ap.add_argument("--tiny", action="store_true",
                    help="toy models on the CPU (a self-test); size / respace / cutn default "
                         "to 64 / ddim10 / 2")
    return ap


def run(argv=None) -> list:
    """Both arms (``--arms``) as ``main`` runs them: the records, printed as
    they come, then the speedup's."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.tiny:
        for k, v in {"size": 64, "respace": "ddim10", "cutn": 2}.items():
            if getattr(args, k) == ap.get_default(k):
                setattr(args, k, v)
    payload = {"image_size": args.size, "timestep_respacing": args.respace,
               "num_cutouts": args.cutn, "clip_model_name": args.clip}
    if not args.tiny:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("serve_throughput: the daemon runs on a CUDA card, and "
                               "torch.cuda.is_available() is False (--tiny runs on the CPU)")
    if args.tiny:  # the CPU's path: f32 (bf16 on the CPU is slow, and the card's type)
        payload["compute_dtype"] = "float32"
    results = []
    for name in args.arms.split(","):
        if name not in ARM_ENV:
            raise ValueError(f"--arms: unknown arm {name!r} (before, after)")
        results.append(run_arm(name, payload, args))
        print(json.dumps(results[-1]), flush=True)
    if len(results) == 2:
        b, a = results[0]["req_per_hour"], results[1]["req_per_hour"]
        results.append({"speedup": round(a / b, 3)})
        print(json.dumps(results[-1]), flush=True)
    return results


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
