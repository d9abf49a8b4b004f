"""What the benchmark loads, checked in fresh interpreters: the command's
modules (the harness, every metric reader and count, and the program's
API with what it imports) load nothing whose top-level module name is
``jax``, ``jaxlib``, ``flax`` or ``cgd_tpu`` (compared whole:
``cgd_tpu_torch`` is the program), and the reference loads nothing of the
program either."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

_LOADED = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
for mod in {mods!r}:
    __import__(mod)
from bench_h100.harness.cells import load
for kind in ("metrics", "counts"):
    for path in sorted(glob.glob(os.path.join({root!r}, "bench_h100", kind, "*.py"))):
        if not path.endswith("__init__.py"):
            load(path, kind + "_" + os.path.basename(path)[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(mods):
    out = subprocess.run([sys.executable, "-c", _LOADED.format(root=ROOT, mods=mods)],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_command_loads_no_jax():
    names = _top_level(["bench_h100.run", "bench_h100.harness.window", "bench_h100.calibrate",
                        "cgd_tpu_torch.api", "cgd_tpu_torch.kernels._build",
                        "cgd_tpu_torch.models.clip.tokenizer"])
    assert "cgd_tpu_torch" in names and "bench_h100" in names
    assert not names & {"jax", "jaxlib", "flax", "cgd_tpu"}, names & {"jax", "cgd_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(["bench_h100.reference.sampling", "bench_h100.reference.png"])
    assert not names & {"jax", "jaxlib", "flax", "cgd_tpu", "cgd_tpu_torch"}


def test_the_harness_checks_loaded_modules_by_whole_names(monkeypatch):
    from bench_h100.harness import window

    monkeypatch.setitem(sys.modules, "cgd_tpu_torch_extra", sys)  # not the JAX package
    assert "cgd_tpu_torch_extra" not in window.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cgd_tpu.api", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"cgd_tpu.api", "jax.numpy"} <= set(window.forbidden_modules())


def test_the_command_refuses_without_a_card(tmp_path):
    """No result without a card: exit 2, an empty standard output."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_h100", "run.py"),
                          "--workload", "cog256", "--seed", str(2 ** 33 + 5), "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path)))
    assert out.returncode == 2 and out.stdout == ""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        assert json.load(f)["command"] == ["python3", "bench_h100/run.py"]
