"""The port's serving daemon (cgd_tpu_torch/serve.py) on the CPU, with the
cases of tests/test_serve.py run against it (``--device cpu``, toy models:
CGD_TPU_DEBUG_TINY=1, random weights, 64px, f32), and two more: the
``CGD_TPU_SERVE_PIPELINE=0`` control arm takes the device lock BEFORE it
arms the stall detector (a request queued behind another is not a stall),
and a failure after a stream's 200 ends the stream with a JSON part and the
terminal boundary, never a 400. Also the pinned copies: the stall watchdog
(the cases of tests/test_watchdog.py, and its code equal to
cgd_tpu/utils/watchdog.py's), warmup's ``parse_spec``, the API's stall pets
(the JAX package's cadence), ``--warmup`` and the Cog predictor. PNGs are
compared by their magic bytes; frames of the same seed and keywords are
compared byte for byte (tolerance: none)."""

import ast
import glob
import json
import os
import queue
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from urllib.parse import urlparse

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu import warmup as jwarmup  # noqa: E402
from cgd_tpu.utils import watchdog as jwatchdog  # noqa: E402
from cgd_tpu_torch import api, serve  # noqa: E402
from cgd_tpu_torch import cog_predict  # noqa: E402
from cgd_tpu_torch import warmup as twarmup  # noqa: E402
from cgd_tpu_torch.io_utils.images import encode_png  # noqa: E402
from cgd_tpu_torch.utils import watchdog as twatchdog  # noqa: E402
from cgd_tpu_torch.utils.watchdog import STALL_EXIT_CODE, StallDetector  # noqa: E402

torch.set_num_threads(2)

PNG = b"\x89PNG\r\n\x1a\n"
REQ = {"image_size": 64, "timestep_respacing": "ddim5", "num_cutouts": 2,
       "compute_dtype": "float32"}


@pytest.fixture()
def server(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    srv = serve.make_server(["--port", "0", "--device", "cpu", "--weights-mode", "random"])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _post(srv, payload, timeout=300):
    req = urllib.request.Request(f"{_url(srv)}/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers["Content-Type"], r.read()


def _post_error(srv, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, payload)
    return ei.value.code, json.loads(ei.value.read())


def test_healthz(server):
    with urllib.request.urlopen(f"{_url(server)}/healthz") as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "backend": "cpu", "devices": 1}


def test_the_daemon_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.make_server(["--port", "0"])


def test_generate_png_equals_a_direct_api_run(server, tmp_path):
    ctype, data = _post(server, dict(REQ, prompt="serve test", seed=3))
    assert ctype == "image/png" and data[:8] == PNG
    paths = [p for _, p in api.clip_guided_diffusion(
        prompts=["serve test"], seed=3, weights_mode="random", device="cpu", progress=False,
        prefix_path=tmp_path / "direct", save_frequency=10**9, **REQ)]
    assert open(paths[-1], "rb").read() == data


def test_generate_png_under_mesh(server):
    from cgd_tpu_torch.parallel.mesh import make_mesh

    server.RequestHandlerClass.mesh = make_mesh(["cpu", "cpu"])
    ctype, data = _post(server, dict(REQ, prompt="serve mesh test", timestep_respacing="ddim4"))
    assert data[:8] == PNG


def test_bad_request(server):
    code, body = _post_error(server, {})
    assert code == 400 and "prompt" in body["error"]


def test_two_overlapping_requests(server):
    results = {}

    def post(key, prompt):
        results[key] = _post(server, dict(REQ, prompt=prompt, timestep_respacing="ddim4"))[1]

    threads = [threading.Thread(target=post, args=(k, p))
               for k, p in (("a", "overlap one"), ("b", "overlap two"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert set(results) == {"a", "b"}
    assert all(d[:8] == PNG for d in results.values())


def _parts(body):
    return body.split(b"--" + serve.STREAM_BOUNDARY.encode())


def test_stream_frames(server):
    ctype, body = _post(server, dict(REQ, prompt="stream test", timestep_respacing="ddim6",
                                     stream=True, save_frequency=2))
    assert ctype == "multipart/x-mixed-replace; boundary=cgdframe"
    parts = _parts(body)
    pngs = [p for p in parts if b"Content-Type: image/png" in p]
    assert len(pngs) == 4  # steps 0, 2, 4 and the final frame 5
    for p in pngs:
        assert p.split(b"\r\n\r\n", 1)[1][:8] == PNG
    assert parts[-1].startswith(b"--")  # terminal boundary, no error part
    assert not any(b"application/json" in p for p in parts)


def test_stream_missing_prompt_is_400(server):
    code, body = _post_error(server, {"stream": True})
    assert code == 400 and "prompt" in body["error"]


def test_stream_pre_frame_failure_is_400(server):
    code, _ = _post_error(server, {"prompt": "x", "stream": True,
                                   "clip_model_name": "/no/such/model.pt"})
    assert code == 400


def test_stream_queue_drops_oldest_keeps_terminal():
    q = queue.Queue(maxsize=3)
    for i in range(5):
        serve._offer(q, ("frame", bytes([i]), 0))
    serve._offer(q, ("done", None, None))
    items = [q.get_nowait() for _ in range(3)]
    assert items[-1] == ("done", None, None)
    assert items[-2] == ("frame", bytes([4]), 0), "newest frame survives"


def test_plain_request_completes_behind_wedged_stream(server):
    u = urlparse(_url(server))
    payload = json.dumps(dict(REQ, prompt="wedged stream", stream=True, save_frequency=1)).encode()
    wedged = socket.create_connection((u.hostname, u.port), timeout=30)
    try:
        wedged.sendall(b"POST /generate HTTP/1.1\r\n"
                       + f"Host: {u.hostname}:{u.port}\r\n".encode()
                       + b"Content-Type: application/json\r\n"
                       + f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        # never read from `wedged`; the plain request must still finish
        _, data = _post(server, dict(REQ, prompt="behind the wedge"))
        assert data[:8] == PNG
    finally:
        wedged.close()


def test_control_arm_serializes_whole_request(server, monkeypatch):
    monkeypatch.setenv("CGD_TPU_SERVE_PIPELINE", "0")
    _, data = _post(server, dict(REQ, prompt="control arm"))
    assert data[:8] == PNG


class _Recorder(StallDetector):
    """A detector that records its stalls instead of exiting."""

    stalls = []

    def __init__(self, timeout_s, **kw):
        super().__init__(timeout_s, on_stall=lambda ph, s: _Recorder.stalls.append(ph))


def test_control_arm_does_not_take_a_queued_request_for_a_stall(server, monkeypatch, tmp_path):
    """The control arm holds the device lock around the whole request: it
    must take the lock before it arms the detector, or a request queued
    behind a long generation is killed as stalled (exit 117). The
    generation itself is a stand-in that writes one frame at once."""
    monkeypatch.setenv("CGD_TPU_SERVE_PIPELINE", "0")
    monkeypatch.setattr(twatchdog, "StallDetector", _Recorder)
    monkeypatch.setattr(server.RequestHandlerClass, "stall_timeout", 1.0)

    def instant(payload, weights_mode, device, stall_pet=None, mesh=None, device_lock=None):
        stall_pet("sampling (1 steps done)")
        scratch = tempfile.mkdtemp(dir=tmp_path)
        path = os.path.join(scratch, "0000.png")
        with open(path, "wb") as f:
            f.write(encode_png(torch.zeros(8, 8, 3, dtype=torch.uint8).numpy()))
        return path, scratch

    monkeypatch.setattr(serve, "_generate", instant)
    _Recorder.stalls.clear()
    results = {}
    assert serve._DEVICE_LOCK.acquire(timeout=10)
    try:  # another generation holds the card for longer than the timeout
        t = threading.Thread(target=lambda: results.setdefault(
            "png", _post(server, {"prompt": "queued"})[1]))
        t.start()
        time.sleep(3.0)
    finally:
        serve._DEVICE_LOCK.release()
    t.join(60)
    assert results["png"][:8] == PNG
    assert _Recorder.stalls == []


def test_a_failure_after_the_200_ends_the_stream_with_a_json_part(server, monkeypatch):
    """Once the 200 and the multipart header are out, a failure of the run
    or of the handler ends the stream with an application/json part and
    the terminal boundary; no 400 status line is written into it."""
    png = encode_png(torch.zeros(8, 8, 3, dtype=torch.uint8).numpy())

    def frames_then_fail(*a, **kw):
        yield 0, png
        raise RuntimeError("the run failed mid-stream")

    monkeypatch.setattr(serve, "_generate_frames", frames_then_fail)
    _, body = _post(server, {"prompt": "x", "stream": True})
    parts = _parts(body)
    assert sum(b"Content-Type: image/png" in p for p in parts) == 1
    assert b"application/json" in parts[-2] and b"the run failed mid-stream" in parts[-2]
    assert parts[-1].startswith(b"--") and b"HTTP/1." not in body

    def frames(*a, **kw):
        yield 0, png
        yield 0, png

    real_write = serve.Handler._write_part
    written = []

    def failing_write(self, boundary, ctype, payload, extra=""):
        if ctype == "image/png" and written:
            raise RuntimeError("the handler failed mid-stream")
        written.append(ctype)
        real_write(self, boundary, ctype, payload, extra)

    monkeypatch.setattr(serve, "_generate_frames", frames)
    monkeypatch.setattr(serve.Handler, "_write_part", failing_write)
    _, body = _post(server, {"prompt": "x", "stream": True})
    parts = _parts(body)
    assert b"the handler failed mid-stream" in parts[-2] and parts[-1].startswith(b"--")
    assert b"HTTP/1." not in body


def test_failed_generate_removes_scratch_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    before = set(glob.glob(os.path.join(tempfile.gettempdir(), "cgd_serve_*")))
    with pytest.raises(AssertionError, match="does not exist"):
        serve._generate({"prompt": "x", "clip_model_name": "/no/such/model.pt"}, "random",
                        "cpu")
    after = set(glob.glob(os.path.join(tempfile.gettempdir(), "cgd_serve_*")))
    assert after == before


def test_the_allowed_keywords_are_the_jax_daemons():
    from cgd_tpu import serve as jserve

    assert serve.ALLOWED_KWARGS == jserve.ALLOWED_KWARGS


def test_serve_warmup_runs_the_generator_before_binding(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    lines = []
    serve.run_warmup(["64:ddim4:2"], device="cpu",
                     log=lambda *a: lines.append(" ".join(map(str, a))))
    assert any("warmed in" in ln and "2 frame yields" in ln for ln in lines)


# ---- pinned copies --------------------------------------------------------

def _body(module):
    """The module's code without its docstring."""
    tree = ast.parse(Path(module.__file__).read_text())
    return ast.dump(ast.Module(tree.body[1:], []))


def test_the_watchdog_is_a_copy_of_the_original():
    assert _body(twatchdog) == _body(jwatchdog)
    assert STALL_EXIT_CODE == jwatchdog.STALL_EXIT_CODE == 117


class TestStallDetector:
    def test_disabled_when_timeout_zero(self):
        with StallDetector(0) as dog:
            assert not dog.enabled and dog._thread is None
        with StallDetector(None) as dog:
            assert not dog.enabled

    def test_pets_keep_it_alive_then_stall_fires(self, tmp_path):
        stalls, report = [], tmp_path / "stall.json"
        with StallDetector(1.5, report_path=str(report),
                           on_stall=lambda ph, s: stalls.append((ph, s))) as dog:
            for _ in range(8):  # ~1.6 s of liveness > timeout: pets reset it
                dog.pet("busy phase")
                time.sleep(0.2)
            assert stalls == []
            dog.pet("device fetch")
            deadline = time.monotonic() + 15
            while not stalls and time.monotonic() < deadline:
                time.sleep(0.05)
        assert len(stalls) == 1
        phase, stalled_for = stalls[0]
        assert phase == "device fetch" and stalled_for >= 1.5
        rec = json.loads(report.read_text())
        assert rec["stalled"] is True and rec["phase"] == "device fetch"
        assert rec["pid"] == os.getpid() and rec["exit_code"] is None

    def test_exit_disarmed_on_clean_close(self):
        fired = []
        dog = StallDetector(0.2, on_stall=lambda ph, s: fired.append(ph))
        with dog:
            dog.pet("quick work")
        time.sleep(0.6)
        assert not dog.stalled and not fired


@pytest.mark.parametrize("spec", ["256:ddim250", "512:1000:8", "64:ddim5:2", "256",
                                  "256:ddim250:16:1", "x:y"])
def test_parse_spec_is_the_jax_packages(spec):
    try:
        want = jwarmup.parse_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            twarmup.parse_spec(spec)
        return
    assert twarmup.parse_spec(spec) == want


def test_the_api_pets_every_phase_and_segment_as_cgd_tpu(monkeypatch, tmp_path):
    """The JAX package's cadence (tests/test_watchdog.py): the phases, then
    one pet per segment with cumulative step counts."""
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    pets = []
    list(api.clip_guided_diffusion(
        prompts=["a b c"], image_size=64, timestep_respacing="ddim10", num_cutouts=2,
        save_frequency=4, weights_mode="random", device="cpu", compute_dtype="float32",
        prefix_path=tmp_path / "out", progress=False, stall_pet=pets.append))
    assert pets[0] == "resolve model checkpoints"
    assert "encode prompts" in pets and "compile + first sampling segment" in pets
    sampling = [p for p in pets if p.startswith("sampling (")]
    assert sampling == [f"sampling ({k} steps done)" for k in (1, 5, 9, 10)]


def test_the_api_pets_while_it_waits_for_the_device_lock(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    lock, pets = threading.Lock(), []
    tries = []

    class SlowLock:
        def acquire(self, timeout=-1):
            tries.append(timeout)
            return len(tries) > 2 and lock.acquire()

        def release(self):
            lock.release()

    list(api.clip_guided_diffusion(
        prompts=["x"], image_size=64, timestep_respacing="ddim4", num_cutouts=2,
        weights_mode="random", device="cpu", progress=False, prefix_path=tmp_path / "o",
        stall_pet=pets.append, device_lock=SlowLock()))
    assert tries == [5.0] * 3
    assert pets.count("waiting for device lock") == 3
    assert not lock.locked()  # released at the end


# ---- the Cog predictor ------------------------------------------------------

def test_the_cog_predictor_yields_the_frames(monkeypatch, tmp_path):
    """setup() resolves the predictor's weights; predict() yields the
    frames as paths, every fifth step and the last. The run is cut to the
    64px class-conditional toy model at f32: the toy 256px model attends
    over 128^2 tokens, minutes a step on the CPU (the mapping to the 256px
    unconditional model is the next test's)."""
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    real = api.clip_guided_diffusion
    monkeypatch.setattr(api, "clip_guided_diffusion", lambda **kw: real(
        **dict(kw, image_size=64, class_cond=True, compute_dtype="float32")))
    pred = cog_predict.ClipGuidedDiffusionPredictor()
    pred.device, pred.weights_mode = "cpu", "random"
    pred.setup()
    frames = list(pred.predict(prompt="a lighthouse", respace="ddim6", num_cutouts=2))
    assert [p.name for p in frames] == ["0000.png", "0005.png"]
    assert all(open(p, "rb").read(8) == PNG for p in frames)


def test_the_cog_predictor_maps_an_init_image_to_half_the_steps(monkeypatch):
    calls = []

    def fake(**kw):
        calls.append(kw)
        yield 0, "frame.png"

    monkeypatch.setattr(api, "clip_guided_diffusion", fake)
    pred = cog_predict.ClipGuidedDiffusionPredictor()
    list(pred.predict(prompt="p", respace="ddim50", init_image="init.png"))
    list(pred.predict(prompt="p", respace="ddim50"))
    assert [(c["skip_timesteps"], c["init_scale"]) for c in calls] == [(25, 1000), (0, 0)]
    assert all(c["image_size"] == 256 and c["class_cond"] is False and c["device"] == "cuda"
               and c["clip_model_name"] == "ViT-B/32" for c in calls)
