"""The rest of the port's API / CLI surface on the CPU (toy models:
CGD_TPU_DEBUG_TINY=1, random weights, 64px, f32): ``-gif`` / ``-mp4``
(cgd_tpu_torch/io_utils/video.py: without ``ffmpeg`` the Pillow / OpenCV
fallbacks, ``None`` when neither imports; the frames kept unless every
requested mux wrote a file), ``--log-losses`` (one line per guided step,
the keys and ``k: v:.3f`` format of the JAX package's live path), W&B
(absent: the JAX package's message; present, a stub module: the scalars and
the per-step triptych), ``--profile`` (a Chrome trace, the port's spans in
it on its clock), asynchronous frames
(the same bytes as synchronous ones; failed writes counted and reported),
and nothing refused any more. Frames are compared byte for byte
(tolerance: none)."""

import json
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgd_tpu.io_utils import video as jvideo  # noqa: E402
from cgd_tpu_torch import api as tapi  # noqa: E402
from cgd_tpu_torch import cli as tcli  # noqa: E402
from cgd_tpu_torch.io_utils import images as timages  # noqa: E402
from cgd_tpu_torch.io_utils import video as tvideo  # noqa: E402

torch.set_num_threads(2)

KW = dict(prompts=["a red cube"], image_size=64, num_cutouts=2, timestep_respacing="ddim5",
          weights_mode="random", device="cpu", compute_dtype="float32", progress=False)
ARGV = ["--prompts", "a red cube", "-size", "64", "-cutn", "2", "-respace", "ddim5",
        "--weights-mode", "random", "--device", "cpu", "--compute-dtype", "float32"]
LOSS_LINE = re.compile(r"^([A-Za-z ]+: -?\d+\.\d{3})(\t[A-Za-z ]+: -?\d+\.\d{3})*$")


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _frames_dir(tmp_path, n=3):
    """n random frames written as a run writes them; returns the prefix."""
    rs = np.random.RandomState(0)
    for k in range(n):
        timages.log_image(rs.uniform(-1, 1, (16, 16, 3)).astype(np.float32), tmp_path / "out",
                          ["mux me"], k, 0)
    return tmp_path / "out"


@pytest.fixture
def no_ffmpeg(monkeypatch):
    real = subprocess.run

    def run(cmd, *a, **kw):
        if cmd and cmd[0] == "ffmpeg":
            raise FileNotFoundError("ffmpeg")
        return real(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "run", run)


def test_the_video_module_is_the_jax_packages():
    import ast
    from pathlib import Path

    def body(m):
        tree = ast.parse(Path(m.__file__).read_text())
        return [ast.dump(n) for n in tree.body[1:] if not isinstance(n, ast.ImportFrom)]

    assert body(tvideo) == body(jvideo)


@pytest.mark.parametrize("pillow", [True, False], ids=["pillow", "no-pillow"])
def test_the_gif_without_ffmpeg(tiny, no_ffmpeg, monkeypatch, pillow):
    pytest.importorskip("PIL")
    prefix = _frames_dir(tiny)
    if not pillow:
        monkeypatch.setitem(sys.modules, "PIL", None)
    gif = tvideo.create_gif_ffmpeg(prefix, ["mux me"], 0)
    if not pillow:
        assert gif is None
        return
    want = jvideo.create_gif_ffmpeg(prefix, ["mux me"], 0)  # the same path, rewritten
    assert gif == want
    ours = open(gif, "rb").read()
    assert ours[:6] == b"GIF89a"
    assert ours == open(tvideo.create_gif_ffmpeg(prefix, ["mux me"], 0), "rb").read()


@pytest.mark.parametrize("opencv", [True, False], ids=["opencv", "no-opencv"])
def test_the_mp4_without_ffmpeg(tiny, no_ffmpeg, monkeypatch, opencv):
    prefix = _frames_dir(tiny)
    if opencv:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    mp4 = tvideo.create_video_ffmpeg(prefix, ["mux me"], 0)
    assert (mp4 is not None) == opencv
    if opencv:
        assert open(mp4, "rb").read()[4:8] == b"ftyp"


def _fake_api(monkeypatch):
    """The API replaced by three frames written as a run writes them."""
    def fake(**kw):
        for k in range(3):
            yield 0, timages.log_image(np.zeros((16, 16, 3), np.float32), kw["prefix_path"],
                                       kw["prompts"], k, 0)

    monkeypatch.setattr(tapi, "clip_guided_diffusion", fake)


@pytest.mark.parametrize("opencv", [True, False], ids=["both-muxed", "mp4-failed"])
def test_the_cli_deletes_the_frames_only_when_every_mux_wrote(tiny, no_ffmpeg, monkeypatch,
                                                              opencv):
    pytest.importorskip("PIL")
    if opencv:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    _fake_api(monkeypatch)
    tcli.main(["--prompts", "mux me", "-gif", "-mp4", "-dir", "out", "-q"])
    frames = sorted((tiny / "out").rglob("*.png"))
    assert (tiny / "out" / "mux_me" / "00_00.gif").is_file()
    assert (tiny / "out" / "mux_me" / "00_00.mp4").is_file() == opencv
    assert len(frames) == (0 if opencv else 3)


def _loss_lines(text):
    return [ln for ln in text.splitlines() if "Loss: " in ln]


def test_loss_lines_have_the_keys_and_format_of_the_jax_live_path(tiny, capsys):
    from cgd_tpu import api as japi

    list(japi.clip_guided_diffusion(**{**KW, "device": ""}, prefix_path=tiny / "j",
                                    log_losses=True))
    jlines = _loss_lines(capsys.readouterr().out)
    list(tapi.clip_guided_diffusion(**KW, prefix_path=tiny / "t", log_losses=True))
    tlines = _loss_lines(capsys.readouterr().out)
    assert len(tlines) == len(jlines) == 5  # one per guided step
    for t, j in zip(tlines, jlines):
        assert LOSS_LINE.match(t) and LOSS_LINE.match(j), (t, j)
        assert [p.split(":")[0] for p in t.split("\t")] == [p.split(":")[0] for p in j.split("\t")]


def test_log_losses_through_the_cli(tiny, capsys):
    tcli.main([*ARGV, "--log-losses", "-q"])
    lines = _loss_lines(capsys.readouterr().out)
    assert len(lines) == 5 and all(LOSS_LINE.match(ln) for ln in lines)
    assert lines[0].split("\t")[0].startswith("CLIP Loss: ")


def test_wandb_absent_goes_on_with_the_jax_message(tiny, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    frames = list(tapi.clip_guided_diffusion(**{**KW, "progress": True}, prefix_path=tiny / "o",
                                             wandb_project="proj", wandb_entity="team"))
    assert len(frames) == 2
    out = capsys.readouterr().out
    assert re.search(r"W&B unavailable \(.*\); continuing without logging\.", out)


def test_wandb_present_logs_the_scalars_and_the_triptych(tiny, monkeypatch):
    logged, inits = [], []

    class FakeRun:
        finished = False

        def log(self, d, **kw):
            logged.append(d)

        def finish(self):
            FakeRun.finished = True

    class FakeImage:
        def __init__(self, img, caption=""):
            self.img, self.caption = img, caption

    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: inits.append(kw) or FakeRun()
    fake.Image = FakeImage
    monkeypatch.setitem(sys.modules, "wandb", fake)
    list(tapi.clip_guided_diffusion(**KW, prefix_path=tiny / "o", wandb_project="proj",
                                    wandb_entity="team", save_frequency=2))
    assert inits[0]["project"] == "proj" and inits[0]["entity"] == "team"
    assert inits[0]["config"]["image_size"] == 64 and FakeRun.finished
    trip = [d for d in logged if "Generations - ddim5" in d]
    assert [d["step"] for d in trip] == [0, 1, 2, 3, 4]  # every guided step
    imgs = trip[0]["Generations - ddim5"]
    assert [im.caption for im in imgs] == ["Noisy Sample", "Denoised Prediction",
                                           "Blended (what CLIP sees)"]
    assert all(im.img.dtype == np.uint8 and im.img.shape == (64, 64, 3) for im in imgs)
    losses = [d for d in logged if "Total Loss" in d]
    grads = [d for d in logged if "Grad" in d]
    assert len(losses) == len(grads) == 5
    assert all(isinstance(v, float) for v in losses[0].values())


def test_profile_writes_a_chrome_trace(tiny, capsys):
    tcli.main([*ARGV, "--profile", "prof", "-q"])
    assert "Profile trace written to prof" in capsys.readouterr().out
    trace = json.loads((tiny / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_profile_trace_holds_the_spans_on_its_clock(tiny, capsys):
    from cgd_tpu_torch.utils import tracing

    tcli.main([*ARGV, "--profile", "prof", "-q"])
    assert tracing.span("after") is tracing.NO_SPAN and tracing.take() == []  # off again
    events = json.loads((tiny / "prof" / "trace.json").read_text())["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    spans = [e for e in events if e.get("cat") == "cgd_span"]
    assert ops and {e["pid"] for e in spans} == {tracing.CHROME_PID}
    names = [e["name"] for e in spans]
    assert names.count("api.request") == 1 and names.count("step") == 5
    assert names.count("images.write") == 5
    # the UNet's operators, recorded by the profiler, lie inside each step.unet span
    for unet in (e for e in spans if e["name"] == "step.unet"):
        inside = [o for o in ops
                  if unet["ts"] <= o["ts"] and o["ts"] + o["dur"] <= unet["ts"] + unet["dur"]]
        assert any(o["name"] == "aten::convolution" for o in inside)


def test_async_frames_equal_sync_frames(tiny):
    sync = [open(p, "rb").read() for _, p in tapi.clip_guided_diffusion(
        **KW, prefix_path=tiny / "sync", save_frequency=1)]
    current = (tiny / "current.png").read_bytes()
    paths = [p for _, p in tapi.clip_guided_diffusion(**KW, prefix_path=tiny / "async",
                                                      save_frequency=1, async_frames=True)]
    assert [open(p, "rb").read() for p in paths] == sync
    assert (tiny / "current.png").read_bytes() == current


def test_async_write_errors_are_counted_and_reported(tiny, monkeypatch, capsys):
    real = timages._write

    def failing(path, data):
        if path.endswith("0002.png"):
            raise OSError("disk full")
        real(path, data)

    monkeypatch.setattr(timages, "_write", failing)
    paths = [p for _, p in tapi.clip_guided_diffusion(**KW, prefix_path=tiny / "o",
                                                      save_frequency=1, async_frames=True)]
    assert len(paths) == 5
    assert "(warning) 1 asynchronous frame write(s) failed" in capsys.readouterr().out
    assert timages.flush_frames() == 0  # counted once


def test_nothing_is_refused_any_more(monkeypatch, tmp_path):
    """Every flag of the JAX CLI reaches the API (``_refuse`` and ``REFUSED``
    are gone)."""
    assert not hasattr(tapi, "_refuse") and not hasattr(tcli, "REFUSED")
    calls = []

    def fake(**kw):
        calls.append(kw)
        return iter(())

    monkeypatch.setattr(tapi, "clip_guided_diffusion", fake)
    monkeypatch.chdir(tmp_path)
    tcli.main(["--prompts", "x", "-proj", "p", "-ent", "e", "--log-losses", "--checkpoint",
               "c.npz", "--resume", "r.npz", "--stall-timeout", "600", "-q"])
    (kw,) = calls
    assert (kw["wandb_project"], kw["wandb_entity"], kw["log_losses"], kw["checkpoint_path"],
            kw["resume_from"], kw["async_frames"]) == ("p", "e", True, "c.npz", "r.npz", True)
    assert callable(kw["stall_pet"])
