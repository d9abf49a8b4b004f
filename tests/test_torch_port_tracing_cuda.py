"""The tracer's clock on a card: a span that wraps a kernel launch and
``torch.cuda.synchronize()`` holds that kernel's device interval, as
``torch.profiler`` records it (kineto's Unix-epoch nanoseconds, and the
microseconds from the trace's start that the benchmark's trace reader
takes), for one of PyTorch's kernels and for the port's K-fwd. So each idle
gap of the device in a profiled stretch can be put down to the innermost
span open at the time.

Each case profiles in a process of its own: on the H100 machine (torch 2.11,
CUDA 12.8) a second profiler session in one process lost the first kernels'
records and shifted or scaled the device timestamps of others; the first
session of a process, as the benchmark's traced run has, recorded every
kernel where it ran.

Marked ``cuda``; imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_tracing_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile(kind: str) -> dict:
    """Runs in the child: three launches, each in a span with a sync, gaps
    between them; returns the spans and the device ops (name, start_ns,
    end_ns) by both of the profiler's clocks."""
    from torch.profiler import ProfilerActivity, profile

    from cgd_tpu_torch.kernels import conv3x3 as k3
    from cgd_tpu_torch.utils import tracing

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    if kind == "torch_gemm":
        a = torch.randn(2048, 2048, generator=gen, device=dev).to(torch.bfloat16)

        def run():
            a @ a
    else:
        x = torch.randn(1, 64, 64, 256, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(3, 3, 256, 256, generator=gen, device=dev) / 48).to(torch.bfloat16)
        bias = torch.zeros(256, device=dev, dtype=torch.bfloat16)

        def run():
            k3.reset_launch_counts()
            k3.conv3x3_fwd(x, w, bias)
            assert k3.LAUNCHES["conv3x3_fwd"] == 1

    run()  # built and warmed outside the trace
    torch.cuda.synchronize(dev)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with tracing.span("launch"):
                run()
                torch.cuda.synchronize(dev)
            torch.cuda._sleep(1_000_000)  # a gap between the spans
            torch.cuda.synchronize(dev)
    spans = sorted((s.start_ns, s.end_ns) for s in tracing.take() if s.name == "launch")
    kr = prof.profiler.kineto_results
    t0 = kr.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name, t0 + round(e.time_range.start * 1e3), t0 + round(e.time_range.end * 1e3))
           for e in prof.events() if e.device_type == cuda and "spin" not in e.name]
    raw = [(e.name(), e.start_ns(), e.end_ns()) for e in kr.events()
           if e.device_type() == cuda and "spin" not in e.name()]
    return {"spans": spans, "ops": ops, "raw": raw}


@pytest.mark.parametrize("kind", ["torch_gemm", "kfwd"])
def test_a_span_around_a_kernel_and_a_sync_holds_its_device_interval(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    child = subprocess.run([sys.executable, os.path.abspath(__file__), kind], cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
    assert child.returncode == 0, child.stderr[-4000:]
    line = next(ln for ln in child.stdout.splitlines() if ln.startswith("PROFILE "))
    got = json.loads(line[len("PROFILE "):])
    spans, ops, raw = got["spans"], got["ops"], got["raw"]
    assert len(spans) == 3
    seen = [(name[:40], (a - spans[0][0]) // 1000, (b - spans[0][0]) // 1000)
            for name, a, b in ops]
    assert len(ops) >= 3 and len(raw) == len(ops), (seen, spans)
    for name, a, b in ops + raw:
        holding = [s for s in spans if s[0] <= a <= b <= s[1]]
        assert len(holding) == 1, (name, a, b, spans)
    # each span holds work of its own
    for s in spans:
        assert any(s[0] <= a <= s[1] for _, a, _ in ops), (s, seen, spans)


if __name__ == "__main__":  # the child of each case
    sys.path.insert(0, ROOT)
    print("PROFILE " + json.dumps(_profile(sys.argv[1])))
