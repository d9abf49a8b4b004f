"""Whole runs of the harness on the CPU at toy size (``toy.py``: the card's
look skipped, the port's registries at toy widths):

- a cell and a metric added from files alone (a configuration, a traffic
  mix, a limit, a metric reader, entries in ``BENCHMARK.json``) run and
  report, with no file of the benchmark edited;
- at float32 the program's frames equal the reference's to the last level
  of a few pixels, so ``correct`` is true;
- with the timed path broken underneath, ``correct`` comes out false: a
  step that returns its state unchanged, a frame altered where it is
  written, half of the batch left out (its images copied from the other
  half). The cells run on one card, so no exchange between cards can be
  left out;
- a request whose frames come out all 0 or 255 (a non-finite prediction)
  counts as failed.
"""

import json
import os

import pytest
import torch

from bench_h100.tests import toy

torch.set_num_threads(4)

METRIC = '''"""toy_saved_frames: the frames saved in the window."""


def read(ctx):
    return len(ctx.gaps_ms) + 1
'''


def _add_metric(root):
    with open(os.path.join(root, "bench_h100", "metrics", "toy_saved_frames.py"), "w") as f:
        f.write(METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["end_to_end"].append(dict(name="toy_saved_frames", unit="frames", better="higher",
                                    bound=0.25, source="host_clock", workloads=["toy"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_a_cell_and_a_metric_from_files_alone(tmp_path, monkeypatch):
    before = {}
    for dirpath, _, files in os.walk(toy.HERE):
        for name in files:
            if name.endswith((".py", ".json")):
                with open(os.path.join(dirpath, name), "rb") as f:
                    before[os.path.join(dirpath, name)] = f.read()
    root = toy.make_root(tmp_path)
    _add_metric(root)
    res = toy.run(monkeypatch, tmp_path, root, seconds=0.5)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"image_steps_per_s", "setup_s", "toy_saved_frames"}
    assert res["metrics"]["toy_saved_frames"]["value"] >= 2
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    # float32 on both sides: a few pixels a level apart at most
    assert all(n["value"] < 1e-4 for n in res["checked"].values())
    for path, data in before.items():  # the benchmark's own files untouched
        with open(path, "rb") as f:
            assert f.read() == data, path


def _broken(monkeypatch, fault):
    from cgd_tpu_torch.diffusion import gaussian
    from cgd_tpu_torch.io_utils import images
    from cgd_tpu_torch.models import unet

    if fault == "state unchanged":  # the DDIM and the ancestral update
        for name in ("ddim_sample_step", "p_sample_step"):
            monkeypatch.setattr(gaussian.GaussianDiffusion, name, lambda self, out, x, *a, **k: x)
    elif fault == "answer altered":
        encode = images.encode_png

        def altered(rgb):
            rgb = rgb.copy()
            rgb[: rgb.shape[0] // 4] = 255 - rgb[: rgb.shape[0] // 4]
            return encode(rgb)

        monkeypatch.setattr(images, "encode_png", altered)
    elif fault == "half the batch":
        forward = unet.UNet.forward

        def half(self, x, t, y=None, **kw):
            n = x.shape[0] // 2
            out = forward(self, x[:n], t[:n], None if y is None else y[:n], **kw)
            return torch.cat([out, out], dim=0)

        monkeypatch.setattr(unet.UNet, "forward", half)


@pytest.mark.parametrize("fault", ["state unchanged", "answer altered", "half the batch"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    root = toy.make_root(tmp_path, call=dict(toy.CALL, batch_size=2), limit=0.005)
    sound = toy.run(monkeypatch, tmp_path, root, seed=7, seconds=0.3)
    assert sound["correct"] is True
    _broken(monkeypatch, fault)
    res = toy.run(monkeypatch, tmp_path, root, seed=7, seconds=0.3)
    assert res["correct"] is False
    assert max(n["value"] for n in res["checked"].values()) > 10 * max(
        max(n["value"] for n in sound["checked"].values()), 1e-4)


def test_a_non_finite_prediction_fails_its_request(tmp_path, monkeypatch):
    """A UNet that predicts NaN: its frames are written all 0, and the
    request counts as failed."""
    from cgd_tpu_torch.models import unet

    root = toy.make_root(tmp_path)
    forward = unet.UNet.forward
    monkeypatch.setattr(unet.UNet, "forward",
                        lambda self, *a, **k: forward(self, *a, **k) * float("nan"))
    res = toy.run(monkeypatch, tmp_path, root, seconds=0.3)
    assert res["failed"] >= 1 and res["correct"] is False


def test_the_ancestral_path_with_class_labels_equals_the_reference(tmp_path, monkeypatch):
    """Respacing "25" (no "ddim"): the ancestral step with the learned
    variance and the step noise, class labels drawn every step."""
    unet = dict(toy.UNET, class_cond=True)
    call = dict(toy.CALL, timestep_respacing="25", save_frequency=1, randomize_class=True)
    root = toy.make_root(tmp_path, call=call, unet=unet)
    with open(os.path.join(root, "bench_h100", "traffic", "toy.json")) as f:
        traffic = json.load(f)
    traffic["check"]["steps"] = [0, 1, 2, 3]
    with open(os.path.join(root, "bench_h100", "limits", "toy.json"), "w") as f:
        json.dump({f"frame_mad_s{s}": {"limit": 0.01} for s in range(4)}, f)
    with open(os.path.join(root, "bench_h100", "traffic", "toy.json"), "w") as f:
        json.dump(traffic, f)
    res = toy.run(monkeypatch, tmp_path, root, seconds=1.0, unet=unet)
    assert res["correct"] is True
    assert all(n["value"] < 1e-4 for n in res["checked"].values())


def test_a_window_closed_per_request_spans_whole_requests(tmp_path, monkeypatch, capsys):
    """``window.close`` "request": the window closes at a request's first
    frame, the phase it opened at, so it holds whole requests (ddim10: a
    multiple of 10 image-steps)."""
    import re

    root = toy.make_root(tmp_path, close="request")
    res = toy.run(monkeypatch, tmp_path, root, seconds=0.2)
    assert res["correct"] is True and res["attempted"] >= 2
    steps = int(re.search(r"\[window\] [\d.]+ s, (\d+) image-steps", capsys.readouterr().err)[1])
    assert steps > 0 and steps % 10 == 0
