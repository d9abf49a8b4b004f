"""``cgd_tpu_torch/tools/run_acceptance.py`` against ``tools/run_acceptance.py``.

The configs (argv for argv) and the keys of the JSON line per config are
pinned to the JAX tool, read as text (it imports the JAX package's CLI
through a subprocess, and Pillow). The init image is written without
Pillow and decodes to the JAX tool's gradient. ``main`` runs the configs
that ``--only`` names, appends their lines to ``--out`` and exits 1 if one
failed; the processes themselves run on the card (chip_smoke.py phase 14e).
"""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from cgd_tpu_torch.io_utils.images import decode_png
from cgd_tpu_torch.tools import run_acceptance as tool

JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "run_acceptance.py"


def _jax_tree():
    return ast.parse(JAX_TOOL.read_text())


def _jax_configs() -> dict:
    for node in _jax_tree().body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "CONFIGS":
            return eval(compile(ast.Expression(node.value), str(JAX_TOOL), "eval"),
                        {"__builtins__": {}, "dict": dict})
    raise AssertionError("no CONFIGS in tools/run_acceptance.py")


def _record_keys(tree) -> set:
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "rec"
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec = {...}")


def test_the_configs_are_the_jax_tools():
    assert tool.CONFIGS == _jax_configs()
    assert list(tool.CONFIGS) == ["cfg2_128_multiprompt", "cfg3_256_init_vgg",
                                  "cfg4_512_rn50x16", "cfg5_256_nonsquare_reduce_mp4"]


def test_the_json_line_has_the_jax_tools_keys():
    port = ast.parse(Path(tool.__file__).read_text())
    assert _record_keys(port) == _record_keys(_jax_tree())


def test_the_options_are_the_jax_tools():
    def flags(tree):
        return {a.value for node in ast.walk(tree) if isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"
                for a in node.args[:1] if isinstance(a, ast.Constant)}

    assert flags(ast.parse(Path(tool.__file__).read_text())) == flags(_jax_tree()) == {
        "--only", "--out", "--outdir"}


def test_the_init_image_is_the_jax_tools_gradient_without_pillow(tmp_path):
    tool.make_init_image(tmp_path / "init.png", size=32)
    img = decode_png((tmp_path / "init.png").read_bytes())
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    r = np.exp(-(((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.06))
    want = np.stack([0.2 + 0.6 * xx + 0.3 * r, 0.3 + 0.4 * yy + 0.2 * r, 0.5 + 0.4 * r], -1)
    np.testing.assert_array_equal(img, (np.clip(want, 0, 1) * 255).astype(np.uint8))


def test_run_config_runs_the_ports_cli_in_a_fresh_process(tmp_path, monkeypatch):
    seen = {}

    class Done:
        returncode, stderr = 0, ""

    def fake_run(argv, cwd, capture_output, text, timeout):
        seen.update(argv=argv, cwd=cwd)
        rundir = Path(argv[argv.index("-dir") + 1])
        (rundir / "00").mkdir(parents=True)
        for step in (0, 25):
            (rundir / "00" / f"{step:04}.png").write_bytes(b"png")
        return Done()

    monkeypatch.setattr(tool.subprocess, "run", fake_run)
    key = "cfg3_256_init_vgg"
    rec = tool.run_config(key, tool.CONFIGS[key], tmp_path, tmp_path / "init.png")
    assert seen["argv"][:3] == [sys.executable, "-m", "cgd_tpu_torch.cli"]
    assert seen["argv"][3:] == [*tool.CONFIGS[key]["argv"], "--weights-mode", "random", "-q",
                                "-dir", str(tmp_path / key), "-init", str(tmp_path / "init.png")]
    assert seen["cwd"] == tool.REPO and (tool.REPO / "cgd_tpu_torch" / "cli.py").is_file()
    assert rec["rc"] == 0 and rec["frames"] == 2 and rec["last_frame"] == "00/0025.png"
    assert rec["steps"] == 125 and rec["videos"] == []


@pytest.mark.parametrize("rcs,want", [((0, 0), 0), ((0, 2), 1)])
def test_main_runs_the_named_configs_and_appends_their_lines(tmp_path, monkeypatch, rcs, want):
    keys = ["cfg2_128_multiprompt", "cfg4_512_rn50x16"]
    rc_of = dict(zip(keys, rcs))

    def fake(key, cfg, outdir, init_path):
        assert init_path.is_file() and outdir == (tmp_path / "runs").resolve()
        return {"config": key, "rc": rc_of[key], "wall_s": 1.0, "steps": cfg["steps"],
                "frames": 1}

    monkeypatch.setattr(tool, "run_config", fake)
    out = tmp_path / "lines.jsonl"
    assert tool.main(["--only", *keys, "--out", str(out),
                      "--outdir", str(tmp_path / "runs")]) == want
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [ln["config"] for ln in lines] == keys
