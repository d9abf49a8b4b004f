"""Minimal HTTP serving daemon of the port, counterpart of ``cgd_tpu/serve.py``
(the same endpoints, request keywords and flags, plus ``--device``):

    python -m cgd_tpu_torch.serve --port 8080 [--weights-mode random] [--device cpu]

    POST /generate {"prompt": "...", "image_size": 256,
                    "timestep_respacing": "ddim250", ...any allowed api kwarg}
      -> image/png (the final frame)
    POST /generate {"prompt": "...", "stream": true, ...}
      -> multipart/x-mixed-replace stream: one image/png part per saved
         frame as sampling produces it (``save_frequency``, default 25 when
         streaming), then the terminal boundary. The 200 and the multipart
         header go out with the FIRST frame, so a failure before it is the
         same clean 400 as on the plain path; a failure after it ends the
         open stream with an application/json error part and the terminal
         boundary (never a status line inside the stream). Sampling runs in
         a producer thread that feeds a bounded queue (the oldest frame is
         dropped when it is full), so a slow reader never stalls the card.
    GET  /healthz  -> {"status": "ok", "backend": "cuda", "devices": N}

``--device`` defaults to ``cuda``: without a card the daemon refuses to
start, and the CPU is used only with ``--device cpu``.

Only the device-heavy sampling is serialized, behind one device lock (the
API's ``device_lock``): each request's weight resolution, tokenization and
validation run outside it, so request N+1's host prep overlaps request N's
sampling; an f32 request also encodes its prompts inside the lock, since
only the lock's holder may set the TF32 flags. A request whose checkpoints,
size and dtype match the one before it takes that request's models from
the weights' model cache, already on the card. In-flight requests are
bounded by a semaphore of 3. ``CGD_TPU_SERVE_PIPELINE=0`` serializes whole
requests (the control arm of a throughput comparison); it takes the lock
BEFORE arming the stall detector, so a request queued behind another is not
taken for a stall. Pipelined requests run their guided steps eagerly: a
CUDA graph's capture fails under another thread's device work (the API's
``device_lock`` says so to the sampler); serialized ones replay graphs.

``--warmup SIZE:RESPACE[:CUTN]`` runs the real generator once per spec
before the port is bound (``cgd_tpu_torch/warmup.py``: the kernels' build,
the CUDA context and the library handles). ``make_server(argv)`` builds
the server without serving, for callers that run it in a thread.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import shutil
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_DEVICE_LOCK = threading.Lock()  # one card: serialize sampling only
_INFLIGHT = threading.Semaphore(3)  # 1 sampling + up to 2 in host prep


def _pipelined() -> bool:
    """CGD_TPU_SERVE_PIPELINE=0 serializes whole requests (one lock around
    prep and sampling): the control arm of a serving-throughput comparison."""
    return os.environ.get("CGD_TPU_SERVE_PIPELINE") != "0"


ALLOWED_KWARGS = {
    "image_size", "num_cutouts", "clip_guidance_scale", "tv_scale", "range_scale",
    "sat_scale", "init_scale", "batch_size", "class_cond", "cutout_power",
    "timestep_respacing", "seed", "diffusion_steps", "skip_timesteps",
    "clip_model_name", "randomize_class", "noise_schedule",
    "use_augs", "use_magnitude", "height_offset", "width_offset",
    "reduce_clip", "progressive_cutout", "cached_cutouts",
    "compute_dtype", "strict_parity", "fast_guidance", "dpm_solver",
}


def _open_generation(payload: dict, weights_mode: str, default_save_frequency, device: str,
                     stall_pet=None, mesh=None, device_lock=_DEVICE_LOCK):
    """Request prep shared by both response shapes: validate the payload,
    keep the allowed api kwargs, create the scratch dir, construct the
    sampling generator. Returns (generator, scratch_dir); the caller owns
    the dir."""
    from cgd_tpu_torch.api import clip_guided_diffusion

    prompt = payload.get("prompt", "")
    if not prompt:
        raise ValueError("missing 'prompt'")
    kwargs = {k: v for k, v in payload.items() if k in ALLOWED_KWARGS}
    out_dir = tempfile.mkdtemp(prefix="cgd_serve_")
    gen = clip_guided_diffusion(
        prompts=prompt.split("|"),
        prefix_path=out_dir,
        save_frequency=payload.get("save_frequency", default_save_frequency),
        progress=False,
        weights_mode=weights_mode,
        device=device,
        stall_pet=stall_pet,
        mesh=mesh,
        device_lock=device_lock,
        **kwargs,
    )
    return gen, out_dir


def _generate(payload: dict, weights_mode: str, device: str = "cuda", stall_pet=None,
              mesh=None, device_lock=_DEVICE_LOCK):
    """Run one generation; returns (final_frame_path, scratch_dir). The
    caller removes the scratch dir once the frame is read; a failing
    generation removes it here."""
    from cgd_tpu_torch.validate import FINAL_FRAME_ONLY

    gen, out_dir = _open_generation(payload, weights_mode, FINAL_FRAME_ONLY, device,
                                    stall_pet=stall_pet, mesh=mesh, device_lock=device_lock)
    try:
        last = None
        for _b, path in gen:
            last = path
        return last, out_dir
    except BaseException:
        shutil.rmtree(out_dir, ignore_errors=True)
        raise


def _generate_frames(payload: dict, weights_mode: str, device: str = "cuda", stall_pet=None,
                     mesh=None, device_lock=_DEVICE_LOCK):
    """Yield (batch_idx, png_bytes) per saved frame as sampling produces
    them. The scratch dir lives while the generator is open; closing it,
    normally or by an abandoned stream, removes the tree."""
    gen, out_dir = _open_generation(payload, weights_mode, 25, device,  # progress frames
                                    stall_pet=stall_pet, mesh=mesh, device_lock=device_lock)
    try:
        for batch_idx, path in gen:
            with open(path, "rb") as f:
                yield batch_idx, f.read()
    finally:
        gen.close()
        shutil.rmtree(out_dir, ignore_errors=True)


STREAM_BOUNDARY = "cgdframe"
_STREAM_QUEUE_MAX = 32  # frames buffered ahead of a slow streaming client
_STREAM_WRITE_TIMEOUT = 300.0  # seconds per client write before giving up


def _offer(q, item):
    """Non-blocking put: when the queue is full, drop the OLDEST buffered
    frame. Each multipart/x-mixed-replace part replaces the previous one,
    so a slow client sees fewer intermediate frames; the newest frame and
    the terminal done / error item are never the ones dropped."""
    while True:
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            try:
                q.get_nowait()
            except queue.Empty:
                pass


def _whole_request_lock():
    """The lock that guards one request: under CGD_TPU_SERVE_PIPELINE=0 the
    whole request holds the device lock (taken before the stall detector is
    armed) and the generator gets none; otherwise the generator takes it
    around its sampling. Returns (context, device_lock for the API)."""
    if _pipelined():
        return contextlib.nullcontext(), _DEVICE_LOCK
    return _DEVICE_LOCK, None


def _pump_frames(payload, cfg, q):
    """Streaming producer (its own thread): drain the sampling generator at
    device speed into q as ('frame', png, batch_idx) items, ending with
    ('done', None, None) or ('error', exc, None). All device work, and the
    device lock held across it, lives here: the handler thread only moves
    bytes to the client socket."""
    from cgd_tpu_torch.utils.watchdog import StallDetector

    try:
        lock_ctx, gen_lock = _whole_request_lock()
        with lock_ctx, StallDetector(cfg.stall_timeout, exit_on_stall=True) as dog:
            for batch_idx, png in _generate_frames(
                payload, cfg.weights_mode, cfg.device, stall_pet=dog.pet,
                mesh=cfg.mesh, device_lock=gen_lock,
            ):
                _offer(q, ("frame", png, batch_idx))
        _offer(q, ("done", None, None))
    except BaseException as e:
        _offer(q, ("error", e, None))


class Handler(BaseHTTPRequestHandler):
    weights_mode = "auto"
    device = "cuda"
    stall_timeout = 0.0  # seconds; armed per in-flight request (idle is not a stall)
    mesh = None  # parallel.mesh.Mesh built from --mesh; shared by all requests
    _streaming = False  # set once a stream's 200 is out: no 400 after it

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path != "/healthz":
            self.send_error(404)
            return
        import torch

        kind = torch.device(self.device).type
        devices = torch.cuda.device_count() if kind == "cuda" else 1
        self._send_json(200, {"status": "ok", "backend": kind, "devices": devices})

    def do_POST(self):
        if self.path != "/generate":
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if payload.get("stream"):
                self._stream_generate(payload)
                return
            from cgd_tpu_torch.utils.watchdog import StallDetector

            # a hung card would wedge every later request too: exit 117 so
            # that the supervisor restarts the daemon (utils/watchdog.py)
            with _INFLIGHT:
                lock_ctx, gen_lock = _whole_request_lock()
                with lock_ctx, StallDetector(self.stall_timeout, exit_on_stall=True) as dog:
                    frame, scratch = _generate(payload, self.weights_mode, self.device,
                                               stall_pet=dog.pet, mesh=self.mesh,
                                               device_lock=gen_lock)
            try:
                if frame is None:
                    raise RuntimeError("no frame produced")
                with open(frame, "rb") as f:
                    data = f.read()
            finally:
                shutil.rmtree(scratch, ignore_errors=True)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except Exception as e:  # report, keep serving
            if self._streaming:  # a stream is open: its own error part said so
                return
            self._send_json(400, {"error": str(e)})

    def _write_part(self, boundary: str, ctype: str, body: bytes, extra: str = ""):
        self.wfile.write(
            f"--{boundary}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n{extra}\r\n".encode()
            + body + b"\r\n"
        )

    def _stream_generate(self, payload: dict):
        """``"stream": true``: multipart/x-mixed-replace, one image/png part
        per saved frame. Until the first frame exists nothing is sent, so a
        failure before it propagates to do_POST's 400. Once the 200 and the
        multipart header are out, every failure (of the run, or of this
        handler) ends the stream with an application/json part and the
        terminal boundary; a client that went away ends it silently."""
        b = STREAM_BOUNDARY
        q = queue.Queue(maxsize=_STREAM_QUEUE_MAX)
        with _INFLIGHT:
            producer = threading.Thread(target=_pump_frames, args=(payload, type(self), q),
                                        daemon=True)
            producer.start()
            try:
                kind, val, idx = q.get()
                if kind == "error":
                    raise val  # before the first frame: do_POST's clean 400
                self._streaming = True
                self.send_response(200)
                self.send_header("Content-Type", f"multipart/x-mixed-replace; boundary={b}")
                self.end_headers()
                self.connection.settimeout(_STREAM_WRITE_TIMEOUT)
                err = None
                try:
                    while kind == "frame":
                        self._write_part(b, "image/png", val, f"X-Frame-Batch: {idx}\r\n")
                        self.wfile.flush()
                        kind, val, idx = q.get()
                    if kind == "error":  # the run failed after frames flowed
                        err = val
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return  # the client went away or wedged; the producer ends alone
                except Exception as e:  # this handler failed after the 200
                    err = e
                try:
                    if err is not None:
                        self._write_part(b, "application/json",
                                         json.dumps({"error": str(err)}).encode())
                    self.wfile.write(f"--{b}--\r\n".encode())
                except OSError:
                    return
            finally:
                # keep the in-flight slot until the device work really ends
                producer.join()


def run_warmup(specs_args, mesh=None, device: str = "cuda", log=None) -> None:
    """--warmup: run each operating point once before the daemon binds its
    port, with the daemon's own final-frame-only segmentation (so the first
    request launches nothing it has not launched before)."""
    from cgd_tpu_torch.validate import FINAL_FRAME_ONLY
    from cgd_tpu_torch.warmup import parse_spec, warm_operating_points

    specs = [parse_spec("256:ddim250:16" if s == "default" else s) for s in specs_args]
    warm_operating_points(specs, FINAL_FRAME_ONLY, mesh=mesh, device=device, log=log)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--weights-mode", default="auto", choices=["auto", "random"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (refuses to start without a card) or 'cpu'")
    ap.add_argument("--stall-timeout", type=float, default=0.0, metavar="SECONDS",
                    help="exit 117 (for supervisor restart) if an in-flight request "
                         "makes no progress for SECONDS; set it above the kernels' first "
                         "build. 0 disables")
    ap.add_argument("--mesh", default=None, type=str, metavar="SPEC",
                    help="split every generation over the visible devices of --device: "
                         "'auto', 'data=N', 'cut=M', or 'data=N,cut=M' "
                         "(same grammar as the cgd CLI)")
    ap.add_argument("--warmup", action="append", default=None,
                    metavar="SIZE:RESPACE[:CUTN]",
                    help="run these operating points once BEFORE binding the port "
                         "(repeatable; 'default' = 256:ddim250:16): builds the kernels and "
                         "creates the CUDA context and library handles, with the daemon's "
                         "own final-frame-only segmentation")
    return ap


def make_server(argv=None) -> ThreadingHTTPServer:
    """Parse ``argv``, check the device, build the mesh, warm up, and bind
    the port (0 picks a free one); returns the server, not yet serving.
    Its handler class carries the settings, so two servers in one process
    do not share them."""
    from cgd_tpu_torch.api import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    mesh = None
    if args.mesh:
        from cgd_tpu_torch.parallel.mesh import mesh_from_spec, visible_devices

        mesh = mesh_from_spec(args.mesh, visible_devices(args.device))
        if mesh is not None:
            print(f"serving with mesh {mesh.shape}")
    handler = type("Handler", (Handler,), {
        "weights_mode": args.weights_mode, "device": args.device,
        "stall_timeout": args.stall_timeout, "mesh": mesh,
    })
    if args.warmup:
        run_warmup(args.warmup, mesh=mesh, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), handler)
    print(f"cgd-tpu-torch serving on http://{args.host}:{server.server_address[1]} "
          f"(device={args.device}, weights={args.weights_mode})", flush=True)
    return server


def main(argv=None):
    make_server(argv).serve_forever()


if __name__ == "__main__":
    main()
