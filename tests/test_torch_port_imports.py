"""cgd_tpu_torch never imports jax, nor the JAX package cgd_tpu: every module
of the port is imported in a fresh interpreter (the tests themselves import
both frameworks), and the kernel module imports without nvcc, triton or a
card. chip_smoke.py imports neither and refuses to run without a card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "cgd_tpu_torch").rglob("*.py")
)


def test_every_port_module_is_listed():
    assert "cgd_tpu_torch.kernels.conv3x3" in MODULES
    assert "cgd_tpu_torch.kernels.attention" in MODULES
    assert "cgd_tpu_torch.kernels.warp" in MODULES
    assert "cgd_tpu_torch.api" in MODULES
    assert "cgd_tpu_torch.cli" in MODULES
    assert "cgd_tpu_torch.serve" in MODULES and "cgd_tpu_torch.cog_predict" in MODULES
    for tool in ("time_components", "bench", "clip_score", "first_real_run", "serve_throughput",
                 "guided_quality_proxy", "jax_prng"):
        assert f"cgd_tpu_torch.tools.{tool}" in MODULES
    assert len(MODULES) >= 20


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cgd_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "from cgd_tpu_torch.kernels import _build\n"
        "assert _build._lib is None  # nothing built at import time\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "cgd_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "cgd_tpu"}, roots


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_outside_a_checkout(tmp_path, alone):
    """No card here (or chip_smoke.py copied alone into an empty directory):
    a nonzero exit and no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
