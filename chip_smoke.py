#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (cgd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:
1. require a CUDA card; print ``nvidia-smi --query-gpu=name,power.limit``;
2. build the hand-written kernels from ``cgd_tpu_torch/csrc`` (nvcc, one
   process per source, in parallel);
3. hold each kernel against its plain PyTorch version in bf16 at the shape
   classes of the 256px and 512px UNets (the conv family, K-dx-w at 512^2,
   the attention forward and its three gradients at every T and head dim),
   checking that K-dx, K-dx-w and K-attn-b reruns are bit-identical (bound:
   max |err| <= 1% of the reference's max |value|, the order of bf16
   rounding), and time both;
4. the full-width 256px and 512px class-conditional UNets (random weights,
   every zero-init conv re-drawn so the kernels' output reaches the result):
   forward and input gradient with the kernels against
   ``kernel_routing("plain")`` (bound: relative L2 error <= 5e-2 — two bf16
   routes that round at different points through ~60-90 convs and 16
   attention blocks; a wrong tap, halo or softmax gives O(1)); prints each
   run's peak device memory;
5. the 256px slice through ``cgd_tpu_torch.api.clip_guided_diffusion``: 16
   cutouts, ViT-B/32, ddim25, random weights, the launch counters reset just
   before it and read just after, between two short runs under the plain
   routing for its step time; checks finite frames, written PNGs and that
   every kernel of the path launched;
6. this slice's path through the CLI, ``cgd_tpu_torch.cli.main``: 512px
   class-conditional ADM guided by CLIP RN50x16, 16 cutouts, ddim25, random
   weights, with the same checks, the step time of the plain routing before
   and after it, and the run's peak device memory.

Prints a JSON line of per-kernel results (launches from phase 6), and as
its last line ``{"ok": true, "device": {...}}``. Needs one card; builds
everything it runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FWD_TOL = DX_TOL = ATTN_TOL = 1e-2  # max |err| / max |ref|
UNET_TOL = 5e-2                     # relative L2 error, full UNet
PROMPTS = ["a watercolor painting of a lighthouse:1", "fog:0.5"]


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

    # K-dx-w at the 512px UNet's full-resolution classes (forward Cin -> Cout)
    res["conv3x3_dx_wtiled"] = {"err": 0.0}
    for ci, co in ((128, 128), (256, 128), (128, 6)):
        x = rn(1, 512, 512, ci)
        wt = k3._flip_t(rn(3, 3, ci, co, scale=(9 * ci) ** -0.5))
        A = 1.0 + 0.2 * torch.randn(1, ci, generator=gen, device=dev)
        B = 0.2 * torch.randn(1, ci, generator=gen, device=dev)
        g = rn(1, 512, 512, co)
        got = k3.conv3x3_dx(g, wt, x, A, B, wtiled=True)
        again = k3.conv3x3_dx(g, wt, x, A, B, wtiled=True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K-dx-w 512^2 {ci}->{co}: repeated runs differ")
        want = k3.conv3x3_dx_plain(g, wt, x, A, B)
        line = []
        for part, a, b in zip(("dx", "dA", "dB"), got, want):
            err, rel = _rel_max(a, b)
            line.append(f"{part} {err:.3e} ({rel:.2e})")
            if rel > DX_TOL:
                raise AssertionError(f"K-dx-w 512^2 {ci}->{co} {part}: {rel:.3e} > {DX_TOL}")
            res["conv3x3_dx_wtiled"]["err"] = max(res["conv3x3_dx_wtiled"]["err"], err)
        ms = _time_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B, wtiled=True))
        lms = _time_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B, wtiled=False))
        pms = _time_ms(lambda: k3.conv3x3_dx_plain(g, wt, x, A, B))
        cms = _time_ms(lambda: k3._conv_nhwc(g, wt))
        print(f"[3] K-dx-w 512^2 {ci}->{co}: {', '.join(line)} kernel {ms:.4f} ms "
              f"(K-dx 128-pixel tiles {lms:.4f} ms) plain {pms:.4f} ms (its cuDNN conv alone "
              f"{cms:.4f} ms; bit-identical reruns)")
        if (ci, co) == (128, 128):
            res["conv3x3_dx_wtiled"].update(ms=ms, plain_ms=pms)
    torch.cuda.synchronize()
    return res


def phase_attention(kattn, dev):
    """Phase 3: K-attn-f and K-attn-b against their plain versions, on the
    fused qkv [1, T, 3*N*d] the UNet gives them (N heads of batch 1)."""
    import torch

    gen = torch.Generator(dev).manual_seed(4321)
    # (N, T, d): the 64-512px UNets' d = 64 levels, then the 128px model's
    # d = 128 / 192 / 256 (4 heads at 512 / 768 / 1024 channels)
    cases = [(8, 1024, 64), (16, 256, 64), (16, 64, 64), (4, 1024, 128), (4, 256, 192),
             (4, 64, 256)]
    res = {"attn_fwd": {"err": 0.0}, "attn_bwd": {"err": 0.0}}
    for n, t, d in cases:
        qkv = torch.randn(1, t, 3 * n * d, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(1, t, n * d, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = kattn.split_heads(qkv, n)
        gh = kattn.to_heads(g, n)
        out, lse = kattn.attention_fwd(qkv, n)
        err, rel = _rel_max(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), 1))
        if rel > ATTN_TOL:
            raise AssertionError(f"K-attn-f N{n} T{t} d{d}: {rel:.3e} > {ATTN_TOL}")
        res["attn_fwd"]["err"] = max(res["attn_fwd"]["err"], err)
        dqkv = kattn.attention_bwd(qkv, out, lse, g, n)
        if not torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, n)):
            raise AssertionError(f"K-attn-b N{n} T{t} d{d}: repeated runs differ")
        line = []
        for part, a, b in zip(("dq", "dk", "dv"), dqkv.chunk(3, dim=-1),
                              kattn.attention_bwd_plain(q, k, v, gh)):
            e, r = _rel_max(a, kattn.merge_heads(b, 1))
            line.append(f"{part} {e:.3e} ({r:.2e})")
            if r > ATTN_TOL:
                raise AssertionError(f"K-attn-b N{n} T{t} d{d} {part}: {r:.3e} > {ATTN_TOL}")
            res["attn_bwd"]["err"] = max(res["attn_bwd"]["err"], e)
        fms = _time_ms(lambda: kattn.attention_fwd(qkv, n))
        fpms = _time_ms(lambda: kattn.attention_fwd_plain(q, k, v))
        bms = _time_ms(lambda: kattn.attention_bwd(qkv, out, lse, g, n))
        bpms = _time_ms(lambda: kattn.attention_bwd_plain(q, k, v, gh))
        print(f"[3] K-attn N{n} T{t} d{d}: fwd max|err| {err:.3e} ({rel:.2e}), {', '.join(line)}; "
              f"fwd kernel {fms:.4f} ms plain {fpms:.4f} ms, bwd kernel {bms:.4f} ms plain "
              f"{bpms:.4f} ms (bit-identical reruns)")
        if (n, t, d) == (8, 1024, 64):
            res["attn_fwd"].update(ms=fms, plain_ms=fpms)
            res["attn_bwd"].update(ms=bms, plain_ms=bpms)
    torch.cuda.synchronize()
    return res


def phase_unet(dev, size: int):
    """Phase 4: full-width UNet at ``size`` px, kernels vs plain routing."""
    import torch

    from cgd_tpu_torch.models.unet import Conv, Dense, UNet, UNetConfig
    from cgd_tpu_torch.ops.nn import cast_conv_params, kernel_routing
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    cfg = UNetConfig.from_flags(DIFFUSION_LOOKUP["cond"][size]["model_flags"])
    gen = torch.Generator(dev).manual_seed(7)
    unet = UNet(cfg, device=dev).init_weights(gen)
    with torch.no_grad():  # re-draw every zero-init conv / projection
        for m in unet.modules():
            if isinstance(m, (Conv, Dense)) and m.zero:
                bound = 1.0 / float(torch.tensor(m.kernel.shape[:-1]).prod()) ** 0.5
                m.kernel.uniform_(-bound, bound, generator=gen)
    cast_conv_params(unet, torch.bfloat16)
    n_params = sum(p.numel() for p in unet.parameters())
    x = torch.randn(1, size, size, 3, generator=gen, device=dev)
    t = torch.tensor([500.0], device=dev)
    y = torch.tensor([3], device=dev)
    probe = torch.randn(1, size, size, 6, generator=gen, device=dev)

    def run():
        x_ = x.clone().requires_grad_(True)
        out = unet(x_, t, y, compute_dtype=torch.bfloat16)
        (g,) = torch.autograd.grad((out * probe).sum(), x_)
        return out.detach(), g

    torch.cuda.reset_peak_memory_stats(dev)
    out_k, g_k = run()
    peak_k = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with kernel_routing("plain"):
        out_p, g_p = run()
    peak_p = torch.cuda.max_memory_allocated(dev)
    ms_k = _time_ms(run, iters=5)
    with kernel_routing("plain"):
        ms_p = _time_ms(run, iters=5)
    for name, a, b in (("output", out_k, out_p), ("d/dx", g_k, g_p)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"UNet {name}: non-finite values")
        rel = ((a - b).norm() / b.norm()).item()
        print(f"[4] UNet {size}px ({n_params / 1e6:.1f}M params) {name}: rel L2 err {rel:.3e} "
              f"(max|ref| {b.abs().max().item():.3e})")
        if rel > UNET_TOL:
            raise AssertionError(f"UNet {size}px {name}: rel L2 {rel:.3e} > {UNET_TOL}")
    print(f"[4] UNet {size}px fwd + input grad: kernels {ms_k:.2f} ms, plain routing "
          f"{ms_p:.2f} ms; peak memory kernels {peak_k / 2**30:.2f} GiB, plain "
          f"{peak_p / 2**30:.2f} GiB")
    del unet
    torch.cuda.empty_cache()


def _launches(k3, kattn) -> dict:
    return {**k3.LAUNCHES, **kattn.LAUNCHES}


def _reset_launches(k3, kattn) -> None:
    k3.reset_launch_counts()
    kattn.reset_launch_counts()


def _check_pngs(paths) -> None:
    for p in paths:
        with open(p, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{p}: not a PNG")


def _check_launched(launches: dict, names, phase: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{phase}: kernel {name} was not launched on the path")


def phase_e2e(k3, kattn, dev, out_dir: Path) -> dict:
    """Phase 5: the 256px slice through the public generator."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.ops.nn import kernel_routing

    kwargs = dict(
        prompts=PROMPTS, image_size=256,
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
        with kernel_routing("plain"):
            plain_before, _, _ = timed(12, out_dir / "plain", n_frames=2)
        frames.clear()
        _reset_launches(k3, kattn)
        step_s, total_s, paths = timed(12, out_dir)  # frames at steps 0, 12, 24
        launches = _launches(k3, kattn)
        final = frames[-1]
        with kernel_routing("plain"):
            plain_after, _, _ = timed(12, out_dir / "plain", n_frames=2)
    finally:
        api.log_image = real_log_image

    if len(paths) != 3:
        raise AssertionError(f"expected frames at steps 0, 12, 24; got {paths}")
    if final.shape != (256, 256, 3) or not np.isfinite(final).all():
        raise AssertionError(f"final frame: shape {final.shape}, finite {np.isfinite(final).all()}")
    _check_pngs((*paths, "current.png"))
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 5")
    print(f"[5] 256px ddim25 guided sampling: {step_s * 1e3:.1f} ms per guided step "
          f"(plain routing {plain_before * 1e3:.1f} ms before, {plain_after * 1e3:.1f} ms "
          f"after), {total_s:.2f} s per image incl. model setup; launches {launches}; "
          f"final frame |x|max {np.abs(final).max():.3f}")
    return launches


def phase_cli(k3, kattn, dev, out_dir: Path) -> dict:
    """Phase 6: 512px, CLIP RN50x16, 16 cutouts, ddim25 through the CLI."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api, cli
    from cgd_tpu_torch.ops.nn import kernel_routing

    argv = ["--prompts", "|".join(PROMPTS), "-size", "512", "-clip", "RN50x16", "-cutn", "16",
            "-respace", "ddim25", "--weights-mode", "random", "-freq", "12", "-cgs", "1500",
            "-tvs", "150", "-dir", str(out_dir / "cli"), "-q"]

    def plain_step_s() -> float:
        """Seconds per guided step over 12 steps under the plain routing (the
        API directly: the CLI drains the whole run)."""
        stamps = []
        with kernel_routing("plain"):
            for _ in api.clip_guided_diffusion(
                    prompts=PROMPTS, image_size=512, num_cutouts=16, clip_model_name="RN50x16",
                    timestep_respacing="ddim25", weights_mode="random", save_frequency=12,
                    clip_guidance_scale=1500, tv_scale=150, prefix_path=out_dir / "plain",
                    device=str(dev), progress=False):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                if len(stamps) == 2:
                    break
        return (stamps[1] - stamps[0]) / 12

    frames, stamps = [], []
    real_log_image = api.log_image

    def capture(image, *a, **kw):  # each frame reaches here on the host
        stamps.append(time.perf_counter())
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    plain_before = plain_step_s()
    api.log_image = capture
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        cli.main(argv)
        total_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        api.log_image = real_log_image
    plain_after = plain_step_s()

    pngs = sorted((out_dir / "cli").rglob("*.png"))
    if len(frames) != 3 or len(pngs) != 3:
        raise AssertionError(f"expected frames at steps 0, 12, 24; got {len(frames)}, {pngs}")
    final = frames[-1]
    if final.shape != (512, 512, 3) or not all(np.isfinite(f).all() for f in frames):
        raise AssertionError(f"final frame: shape {final.shape}, finite "
                             f"{[bool(np.isfinite(f).all()) for f in frames]}")
    _check_pngs((*pngs, "current.png"))
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "conv3x3_dx_wtiled", "attn_fwd",
                               "attn_bwd"), "phase 6")
    step_s = (stamps[-1] - stamps[0]) / 24
    print(f"[6] CLI 512px RN50x16 ddim25 guided sampling: {step_s * 1e3:.1f} ms per guided step "
          f"(plain routing {plain_before * 1e3:.1f} ms before, {plain_after * 1e3:.1f} ms after), "
          f"{total_s:.2f} s per image incl. model setup; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches} ({sum(launches.values()) / 25:.1f} per "
          f"step); final frame |x|max {np.abs(final).max():.3f}")
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
    from cgd_tpu_torch.kernels import attention as kattn
    from cgd_tpu_torch.kernels import conv3x3 as k3

    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    res = phase_kernels(k3, dev)
    res.update(phase_attention(kattn, dev))
    phase_unet(dev, 256)
    phase_unet(dev, 512)
    phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke")
    launches = phase_cli(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_512")

    meta = {
        "conv3x3_fwd": ("cgd_tpu_torch/csrc/conv3x3_fwd.cu", "cgd_tpu/kernels/conv_pallas.py:364"),
        "conv3x3_dx": ("cgd_tpu_torch/csrc/conv3x3_dx.cu", "cgd_tpu/kernels/conv_pallas.py:779"),
        "conv3x3_dx_wtiled": ("cgd_tpu_torch/csrc/conv3x3_dx.cu",
                              "cgd_tpu/kernels/conv_pallas.py:680"),
        "attn_fwd": ("cgd_tpu_torch/csrc/attn_fwd.cu", "cgd_tpu/kernels/attention_pallas.py:69"),
        "attn_bwd": ("cgd_tpu_torch/csrc/attn_bwd.cu", "cgd_tpu/kernels/attention_pallas.py:82"),
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
