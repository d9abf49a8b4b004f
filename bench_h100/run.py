"""The benchmark of ``cgd_tpu_torch`` on one NVIDIA card: one run of one cell.

    python3 bench_h100/run.py --workload cog256 --seed 7 --seconds 40 --trace 0

Run from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic mix; the run makes its weights and inputs from
``--seed``, drives ``cgd_tpu_torch.api.clip_guided_diffusion`` for
``--seconds`` after its set-up (``harness/window.py``), checks the frames
against the plain reference (``reference/``), and prints one JSON object
as its last line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``),
``breakdown`` (``--trace 1``) and ``checked`` (each number compared, with
its limit). Without a CUDA card, or with fewer cards than the cell asks
for, it exits 2 and prints no result.

Everything the run writes lies under ``$TMPDIR/bench_h100`` (weights,
frames; removed at the end; ``HOME`` points there for the process, so the
program's download cache is there too) or under ``build/`` in the
checkout (the kernel library, which the program builds there, and the
compiler caches set below).
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from its age in
    /proc), or now where /proc does not say."""
    now = time.perf_counter()
    try:
        import os

        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def environment(run_dir: str) -> None:
    """Caches in fixed places: the run's own files under ``run_dir`` (HOME
    too, for the program's checkpoint cache), compiler caches under the
    checkout's ``build/``."""
    build = os.path.join(ROOT, "build", "bench_h100")
    os.environ["HOME"] = os.path.join(run_dir, "home")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_h100.harness.cells import Cell

    chips = Cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    run_dir = os.path.join(tempfile.gettempdir(), "bench_h100")
    from bench_h100.harness import window

    window.clear(run_dir)
    os.makedirs(run_dir)
    environment(run_dir)
    cwd = os.getcwd()
    os.chdir(run_dir)  # the program writes current.png into the working directory
    try:
        result = window.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            run_dir, T_START)
    finally:
        os.chdir(cwd)
        window.clear(run_dir)
    for name, num in result["checked"].items():  # the numbers compared, last on stderr
        print(f"{name} {num['value']!r} limit {num['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
