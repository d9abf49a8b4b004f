#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (cgd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:
1. require a CUDA card; print ``nvidia-smi --query-gpu=name,power.limit``;
2. build the hand-written kernels from ``cgd_tpu_torch/csrc`` (nvcc);
3. hold each kernel against its plain PyTorch version in bf16 at the 256px
   UNet's shape classes, forward and backward (bound: max |err| <= 1% of the
   reference's max |value|, the order of bf16 rounding), and time both;
4. the full-width 256px class-conditional UNet (random weights, every
   zero-init conv re-drawn so the kernels' output reaches the result):
   forward and input gradient with the kernels against the plain routing
   (bound: relative L2 error <= 5e-2 — two bf16 routes that round at
   different points through ~60 convs; a wrong tap or halo gives O(1));
5. the end-to-end slice through ``cgd_tpu_torch.api.clip_guided_diffusion``
   at 256px, 16 cutouts, ViT-B/32, ddim25, random weights: the full run with
   the launch counters reset just before it, between two short runs under the
   plain routing for its step time; checks finite frames, written PNGs and
   that every kernel of the path launched.

Prints a JSON line of per-kernel results, and as its last line
``{"ok": true, "device": {...}}``. Needs one card; builds everything it runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FWD_TOL = DX_TOL = 1e-2  # max |err| / max |ref|
UNET_TOL = 5e-2          # relative L2 error, full UNet


def _die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel_max(a, b) -> tuple:
    err = (a.float() - b.float()).abs().max().item()
    return err, err / max(b.float().abs().max().item(), 1e-30)


def phase_kernels(k3, dev):
    """Phase 3: each kernel against its plain version at the path's shapes."""
    import torch

    gen = torch.Generator(dev).manual_seed(1234)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # (name, out H=W, cin, cout, prologue, skip, up); for up, H is the output
    cases = [
        ("conv3x3", 256, 3, 256, False, False, False),
        ("conv3x3_gn_silu_add", 256, 256, 256, True, True, False),
        ("conv3x3_gn_silu_up", 128, 512, 512, True, False, True),
        ("conv3x3_gn_silu", 16, 2048, 1024, True, False, False),
        ("conv3x3_gn_silu", 256, 256, 6, True, False, False),
    ]
    res = {"conv3x3_fwd": {"err": 0.0}, "conv3x3_dx": {"err": 0.0}}
    for name, ho, ci, co, pro, sk, up in cases:
        hs = ho // 2 if up else ho
        x = rn(1, hs, hs, ci)
        w = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
        bias = rn(co, scale=0.1)
        A = (1.0 + 0.2 * torch.randn(1, ci, generator=gen, device=dev)) if pro else None
        B = (0.2 * torch.randn(1, ci, generator=gen, device=dev)) if pro else None
        skip = rn(1, ho, ho, co) if sk else None
        out = k3.conv3x3_fwd(x, w, bias, A, B, skip, up)
        ref = k3.conv3x3_fwd_plain(x, w, bias, A, B, skip, up)
        err, rel = _rel_max(out, ref)
        ms = _time_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, up))
        pms = _time_ms(lambda: k3.conv3x3_fwd_plain(x, w, bias, A, B, skip, up))
        # the bare cuDNN conv on the conv's actual (activated, upsampled) input
        h = x if A is None else k3._silu_chain(x, A, B)[2].to(x.dtype)
        h = k3._up2(h) if up else h
        cms = _time_ms(lambda: k3._conv_nhwc(h, w))
        tflops = 2 * ho * ho * 9 * ci * co / ms / 1e9
        print(f"[3] K-fwd {name:20s} {ho}^2 {ci}->{co}: max|err| {err:.3e} "
              f"({rel:.2e} of scale) kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) "
              f"plain {pms:.4f} ms (its cuDNN conv alone {cms:.4f} ms)")
        if rel > FWD_TOL:
            raise AssertionError(f"K-fwd {name} {ho}^2 {ci}->{co}: {rel:.3e} > {FWD_TOL}")
        res["conv3x3_fwd"]["err"] = max(res["conv3x3_fwd"]["err"], err)
        if (ho, ci, co, sk) == (256, 256, 256, True):
            res["conv3x3_fwd"].update(ms=ms, plain_ms=pms)
        if pro and not up:
            g = rn(1, ho, ho, co)
            wt = k3._flip_t(w)
            got = k3.conv3x3_dx(g, wt, x, A, B)
            want = k3.conv3x3_dx_plain(g, wt, x, A, B)
            again = k3.conv3x3_dx(g, wt, x, A, B)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K-dx {name}: repeated runs differ (not deterministic)")
            ms = _time_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B))
            pms = _time_ms(lambda: k3.conv3x3_dx_plain(g, wt, x, A, B))
            cms = _time_ms(lambda: k3._conv_nhwc(g, wt))
            line = []
            for part, a, b in zip(("dx", "dA", "dB"), got, want):
                err, rel = _rel_max(a, b)
                line.append(f"{part} {err:.3e} ({rel:.2e})")
                if rel > DX_TOL:
                    raise AssertionError(f"K-dx {name} {ho}^2 {part}: {rel:.3e} > {DX_TOL}")
                res["conv3x3_dx"]["err"] = max(res["conv3x3_dx"]["err"], err)
            print(f"[3] K-dx  {name:20s} {ho}^2 {ci}->{co}: {', '.join(line)} "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms (its cuDNN conv alone "
                  f"{cms:.4f} ms; bit-identical reruns)")
            if (ho, ci, co) == (256, 256, 256):
                res["conv3x3_dx"].update(ms=ms, plain_ms=pms)
    torch.cuda.synchronize()
    return res


def phase_unet(dev):
    """Phase 4: full-width 256px UNet, kernels vs plain routing."""
    import torch

    from cgd_tpu_torch.models.unet import Conv, Dense, UNet, UNetConfig
    from cgd_tpu_torch.ops.nn import cast_conv_params, conv_routing
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    cfg = UNetConfig.from_flags(DIFFUSION_LOOKUP["cond"][256]["model_flags"])
    gen = torch.Generator(dev).manual_seed(7)
    unet = UNet(cfg, device=dev).init_weights(gen)
    with torch.no_grad():  # re-draw every zero-init conv / projection
        for m in unet.modules():
            if isinstance(m, (Conv, Dense)) and m.zero:
                bound = 1.0 / float(torch.tensor(m.kernel.shape[:-1]).prod()) ** 0.5
                m.kernel.uniform_(-bound, bound, generator=gen)
    cast_conv_params(unet, torch.bfloat16)
    n_params = sum(p.numel() for p in unet.parameters())
    x = torch.randn(1, 256, 256, 3, generator=gen, device=dev)
    t = torch.tensor([500.0], device=dev)
    y = torch.tensor([3], device=dev)
    probe = torch.randn(1, 256, 256, 6, generator=gen, device=dev)

    def run():
        x_ = x.clone().requires_grad_(True)
        out = unet(x_, t, y, compute_dtype=torch.bfloat16)
        (g,) = torch.autograd.grad((out * probe).sum(), x_)
        return out.detach(), g

    out_k, g_k = run()
    with conv_routing("plain"):
        out_p, g_p = run()
    ms_k = _time_ms(run, iters=5)
    with conv_routing("plain"):
        ms_p = _time_ms(run, iters=5)
    for name, a, b in (("output", out_k, out_p), ("d/dx", g_k, g_p)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"UNet {name}: non-finite values")
        rel = ((a - b).norm() / b.norm()).item()
        print(f"[4] UNet 256px ({n_params / 1e6:.1f}M params) {name}: rel L2 err {rel:.3e} "
              f"(max|ref| {b.abs().max().item():.3e})")
        if rel > UNET_TOL:
            raise AssertionError(f"UNet {name}: rel L2 {rel:.3e} > {UNET_TOL}")
    print(f"[4] UNet fwd + input grad: kernels {ms_k:.2f} ms, plain routing {ms_p:.2f} ms")
    del unet
    torch.cuda.empty_cache()


def phase_e2e(k3, dev, out_dir: Path) -> dict:
    """Phase 5: the slice through the public generator."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.ops.nn import conv_routing

    kwargs = dict(
        prompts=["a watercolor painting of a lighthouse:1", "fog:0.5"], image_size=256,
        num_cutouts=16, clip_model_name="ViT-B/32", timestep_respacing="ddim25",
        weights_mode="random", seed=0, device=str(dev), progress=False,
    )
    frames = []
    real_log_image = api.log_image

    def capture(image, *a, **kw):  # record each frame before it is written
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    def timed(save_frequency, prefix, n_frames=None):
        """Frames at steps 0, f, 2f, ... and the last; returns seconds per
        guided step between the first and the last frame (setup and PNG
        writes of the first frame excluded), seconds from the call to the
        last frame, and the frame paths."""
        stamps, paths = [], []
        t0 = time.perf_counter()
        for _, path in api.clip_guided_diffusion(save_frequency=save_frequency,
                                                 prefix_path=prefix, **kwargs):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            paths.append(path)
            if n_frames is not None and len(paths) == n_frames:
                break
        steps = save_frequency * (len(stamps) - 1) if n_frames else 24
        return (stamps[-1] - stamps[0]) / steps, stamps[-1] - t0, paths

    api.log_image = capture
    try:
        # the host-bound step varies from run to run: time the plain routing
        # before and after the kernels' run, in one process on one card
        with conv_routing("plain"):
            plain_before, _, _ = timed(12, out_dir / "plain", n_frames=2)
        frames.clear()
        k3.reset_launch_counts()
        step_s, total_s, paths = timed(12, out_dir)  # frames at steps 0, 12, 24
        launches = dict(k3.LAUNCHES)
        final = frames[-1]
        with conv_routing("plain"):
            plain_after, _, _ = timed(12, out_dir / "plain", n_frames=2)
    finally:
        api.log_image = real_log_image

    if len(paths) != 3:
        raise AssertionError(f"expected frames at steps 0, 12, 24; got {paths}")
    if final.shape != (256, 256, 3) or not np.isfinite(final).all():
        raise AssertionError(f"final frame: shape {final.shape}, finite {np.isfinite(final).all()}")
    for p in (*paths, "current.png"):
        with open(p, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{p}: not a PNG")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    print(f"[5] 256px ddim25 guided sampling: {step_s * 1e3:.1f} ms per guided step "
          f"(plain routing {plain_before * 1e3:.1f} ms before, {plain_after * 1e3:.1f} ms "
          f"after), {total_s:.2f} s per image incl. model setup; launches {launches}; "
          f"final frame |x|max {np.abs(final).max():.3f}")
    return launches


def main() -> None:
    if not (ROOT / "cgd_tpu_torch").is_dir():
        _die(f"no cgd_tpu_torch/ beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from cgd_tpu_torch.kernels import _build
    from cgd_tpu_torch.kernels import conv3x3 as k3

    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    res = phase_kernels(k3, dev)
    phase_unet(dev)
    launches = phase_e2e(k3, dev, ROOT / "outputs" / "chip_smoke")

    meta = {
        "conv3x3_fwd": ("cgd_tpu_torch/csrc/conv3x3_fwd.cu", "cgd_tpu/kernels/conv_pallas.py:364"),
        "conv3x3_dx": ("cgd_tpu_torch/csrc/conv3x3_dx.cu", "cgd_tpu/kernels/conv_pallas.py:779"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": res[name]["err"],
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"]}
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
