"""The control of the comparison that decides ``correct``: the reference with
every product's operands rounded to fp8 (e4m3, per-tensor scale), the
precision step below the bfloat16 the configurations state, in the
program's place. It has to read above one of each cell's limits.

On the CPU at toy widths, each cell's call (its respacing, scales, save
cadence, batch, init image): one of the control's ``frame_mad_s<step>``
against the float32 reference is above the cell's limit for it. On the
card (marked ``cuda``), at the cell's own size, three seeds: the control
above a limit and the program below every limit (``calibrate.py``'s
readings)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from bench_h100.harness import weights as wmod
from bench_h100.harness.cells import Cell
from bench_h100.reference.sampling import Reference, compare
from bench_h100.tests import toy

torch.set_num_threads(4)
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_each_cells_limit_at_toy_size(tmp_path, cell):
    c = Cell(ROOT, cell)
    call = dict(c.traffic["call"], num_cutouts=4, seed=3, prompts=["a fox in the snow"],
                image_size=128)
    unet = dict(toy.UNET, class_cond=c.config["unet"]["class_cond"],
                rescale_timesteps=c.config["unet"]["rescale_timesteps"])
    config = dict(unet=unet, clip=toy.CLIP)
    weights = wmod.make_weights(config, 5, "cpu", bool(call.get("init_scale")))
    bpe = str(tmp_path / "bpe.txt.gz")
    wmod.write_merge_table(bpe, 5, ["a", "fox", "in", "the", "snow"])
    if c.traffic.get("init_image"):
        call["init_image"] = str(tmp_path / "init.png")
        wmod.write_init_image(call["init_image"], 5, 128)
    sd = {k: {n: torch.from_numpy(np.asarray(v)) for n, v in m.items()} for k, m in weights.items()}
    steps = c.traffic["check"]["steps"]
    want = dict(Reference(config, sd, "cpu", "float32", bpe).frames(call, max(steps)))
    got = dict(Reference(config, sd, "cpu", "fp8", bpe).frames(call, max(steps)))
    assert any(max(compare(got[s][b], want[s][b]) for b in range(call["batch_size"]))
               > c.limits[f"frame_mad_s{s}"]["limit"] for s in steps)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_program_at_the_cells_size(card, cell):
    from bench_h100 import calibrate

    limits = {k: v["limit"] for k, v in Cell(ROOT, cell).limits.items()}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        calibrate.main(["--workload", cell, "--seeds", "101-103", "--control", "101-103"])
    readings = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    assert len(readings) == 3
    for r in readings:
        assert r["correct"] and all(r["program"][k] < lim for k, lim in limits.items()), r
        assert any(r["control"][k] > lim for k, lim in limits.items()), r
