"""``cgd_tpu_torch/tools/serve_throughput.py --tiny`` on the CPU: one arm
of the daemon (a fresh ``python -m cgd_tpu_torch.serve --device cpu``
process on a free port, the toy models), one warm and two timed requests,
each answered with a PNG (the tool raises on any other answer), and the
JAX tool's record keys."""

import pytest

pytest.importorskip("torch")

from cgd_tpu_torch.tools import serve_throughput  # noqa: E402


def test_one_arm_on_the_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the daemon's torch threads, beside the workers
    results = serve_throughput.run(["--tiny", "--requests", "2", "--arms", "after",
                                    "--respace", "ddim4", "--timeout", "300"])
    assert len(results) == 1
    rec = results[0]
    assert set(rec) == {"arm", "warm_s", "requests", "wall_s", "s_per_request", "req_per_hour",
                        "mean_latency_s"}
    assert rec["arm"] == "after" and rec["requests"] == 2 and rec["req_per_hour"] > 0


def test_arms_are_checked_and_ports_are_free():
    with pytest.raises(ValueError, match="unknown arm"):
        serve_throughput.run(["--tiny", "--arms", "sideways"])
    a, b = serve_throughput.free_port(), serve_throughput.free_port()
    assert a > 0 and b > 0
    assert serve_throughput.ARM_ENV["before"] == {"CGD_TPU_SERVE_PIPELINE": "0"}
