#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (cgd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:
1. require a CUDA card; print ``nvidia-smi --query-gpu=name,power.limit``;
2. build the hand-written kernels from ``cgd_tpu_torch/csrc`` (nvcc, one
   process per source, in parallel), print what ptxas said of each
   attention kernel (registers, spill bytes, wgmma serialization), and time
   the host's TMA tensor-map encode that every conv launch makes;
3. hold each kernel against its plain PyTorch version in bf16 at the shape
   classes of the 256px and 512px UNets (the conv family, including the
   512px UNet's own 512^2 128->128 prologue+residual class, K-dx-w at
   512^2) and of the 128px model (the attention at every T and head dim,
   with ragged T and batches at d = 192 / 256), checking that K-dx, K-dx-w
   and K-attn-b reruns are bit-identical (bound: max |err| <= 1% of the
   reference's max |value|, the order of bf16 rounding), and time both: every
   conv row by CUDA events and by its device time under torch.profiler,
   beside cuDNN's bare conv on the same input (eager and device), with
   TFLOP/s and share of the bound on the device time; the attention kernels
   by their device time (torch.profiler), eager time and host us per call,
   beside F.scaled_dot_product_attention's; K-fwd f32 at the LPIPS VGG16's
   conv shapes at 256^2, each forward and its input gradient, against its
   plain version (cuDNN in full f32; bound 1% of the reference's max) and,
   beside cuDNN's, against f64, timed beside cuDNN's f32 conv with TF32 off
   and on, with its share of the TF32 bound, and summed over one guided
   step's 39 launches;
4. the full-width 256px, 512px and 128px class-conditional UNets (random
   weights, every zero-init conv re-drawn so the kernels' output reaches the
   result): forward and input gradient with the kernels against
   ``kernel_routing("plain")`` (bound: relative L2 error <= 5e-2 — two bf16
   routes that round at different points through ~60-90 convs and 16
   attention blocks; a wrong tap, halo or softmax gives O(1)); prints each
   run's peak device memory; then the full-width VGG16 LPIPS distance and
   its input gradient at 256^2 on K-fwd f32 against the plain routing (f32;
   bound: relative L2 error <= 1e-2), both and the plain routing with
   cuDNN's TF32 also against f64 (the gradient passes through thirteen
   convs and the taps' unit normalisation, which amplify the convs'
   rounding);
5. the 256px slice through ``cgd_tpu_torch.api.clip_guided_diffusion``: 16
   cutouts, ViT-B/32, ddim25, random weights, the launch counters reset just
   before it and read just after, between two short runs under the plain
   routing for its step time; checks finite frames, written PNGs and that
   every kernel of the path launched; then the same at the API's default
   size, the 128px model (attention at d = 128, 192 and 256), checking that
   the attention launched at each of the three head dims;
6. the 512px path through the CLI, ``cgd_tpu_torch.cli.main``: 512px
   class-conditional ADM guided by CLIP RN50x16, 16 cutouts, ddim25, random
   weights, with the same checks, the step time of the plain routing before
   and after it, and the run's peak device memory;
7. the height-split mesh path on the one card, ``make_mesh([dev, dev])``
   (cut=2, shards run one after the other): (a) K-halo through
   ``kernels.conv_spmd``, forward and input gradient, against its plain
   version at the shard shapes of the 256px and 512px UNets (bound 1% of the
   reference's max), timed (CUDA events and device time) beside K-fwd on
   the same shard, the plain version and cuDNN on the concatenated input; (b) the full-width 512px UNet split
   in two against the unsplit kernel UNet, forward and input gradient
   (relative L2 <= 5e-2); (c) the 256px ViT-B/32 ddim25 guided run through
   ``api.clip_guided_diffusion(mesh=...)``, counters reset just before it
   and read just after: finite frames, PNGs, K-halo and attention launched,
   K-fwd and K-dx not;
8. the 256px init-image path from checkpoints in the reference layout: the
   port's random 256px UNet, CLIP ViT-B/32 and LPIPS VGG16 written as the
   published ``.pt`` / ``.pth`` files (the converters' name maps inverted
   here) into a directory under ``outputs/``, then
   ``api.clip_guided_diffusion(weights_mode="auto", init_image=...,
   skip_timesteps=12, init_scale=1000, image_prompts=[...])``, ddim25, 16
   cutouts, the tokenizer built from a tiny merge table; counters reset
   just before it and read just after: the ``.npz.cgd`` caches written and
   hit (read back bit-equal with the ``.pt`` files gone), finite frames,
   PNGs, 39 K-fwd f32 launches per guided step, K-fwd, K-dx and the
   attention launched; its step time beside phase 5's; the directory is
   deleted after.

Prints a JSON line of per-kernel results (launches from phase 6, K-halo's
from phase 7c, K-fwd f32's from phase 8; each with its eager and device
time, its bound on the card and the library call's time where there is
one; K-fwd f32's summed over one guided step's 39 launches), and as its
last line ``{"ok": true, "device": {...}}``.
Needs one card; builds everything it runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FWD_TOL = DX_TOL = ATTN_TOL = HALO_TOL = 1e-2  # max |err| / max |ref|
UNET_TOL = 5e-2                                # relative L2 error, full UNet
LPIPS_TOL = 1e-2                               # relative L2 error, full VGG16 LPIPS
PROMPTS = ["a watercolor painting of a lighthouse:1", "fog:0.5"]
# the least time of a kernel: NVIDIA's H100 SXM data sheet, dense bf16 and
# TF32 tensor-core rates and HBM3 bandwidth (at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# the LPIPS VGG16's 3x3 convs at a 256^2 input: (H = W, Cin, Cout, how many)
VGG16_CONVS = [(256, 3, 64, 1), (256, 64, 64, 1), (128, 64, 128, 1), (128, 128, 128, 1),
               (64, 128, 256, 1), (64, 256, 256, 2), (32, 256, 512, 1), (32, 512, 512, 2),
               (16, 512, 512, 3)]
# a tiny BPE merge table (the real one is not in the repository)
BPE_MERGES = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>", "h e", "he l", "hel l",
              "hell o</w>"]


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


def _device_ms(fn) -> float:
    """Device ms per call: the durations of the kernels ``fn`` launches,
    summed under torch.profiler over 20 calls (cgd_tpu_torch/tools/attn_bench.py)."""
    from cgd_tpu_torch.tools.attn_bench import device_ms

    return device_ms(fn)[0]


def _attn_ptxas(log: str) -> list:
    """Per attention kernel of the build (nvcc -Xptxas -v): its registers,
    spill bytes, and any wgmma serialization warning (C7512 / C7513)."""
    import re

    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(_ZN3cgd(\d+)(attn\w*?)(\d+)(\w+)')", line)
        if not m or not m.group(3).startswith("attn") or len(m.group(3)) != int(m.group(2)):
            continue
        mangled, ns, rest = m.group(1)[:-1], m.group(3), m.group(5)
        fn = rest[:int(m.group(4))]
        tmpl = re.match(r"ILi(\d+)E", rest[len(fn):])
        info = " ".join(x.strip() for x in lines[i + 1:i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
        regs = re.search(r"Used (\d+) registers", info)
        warn = sorted({w for w in re.findall(r"\((C751\d)\)[^']*'" + mangled, log)})
        out.append(f"{ns}::{fn}{f'<{tmpl.group(1)}>' if tmpl else ''}: "
                   f"{regs.group(1) if regs else '?'} registers, spill stores / loads "
                   f"{spill.group(1) if spill else '?'} / {spill.group(2) if spill else '?'} bytes"
                   f"{', ' + ', '.join(warn) if warn else ''}")
    return out


def _rel_max(a, b) -> tuple:
    err = (a.float() - b.float()).abs().max().item()
    return err, err / max(b.float().abs().max().item(), 1e-30)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over the dense peak (bf16 unless ``peak`` says TF32) and the bytes (each
    input read once, each output written once) over the HBM bandwidth."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _fmt(bound: dict, ms: float = None) -> str:
    """The bound, and with ``ms`` the kernel's share of it (bound / time)."""
    share = "" if ms is None else f", {bound['bound_ms'] / ms:.1%} of it reached"
    return f"; bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}{share}"


def _tflops(flops: float, ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


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
        ("conv3x3_gn_silu_add", 512, 128, 128, True, True, False),
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
        dms = _device_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, up))
        cdms = _device_ms(lambda: k3._conv_nhwc(h, w))
        flops = 2 * ho * ho * 9 * ci * co
        bd = _bound(flops, _nbytes(x, w, bias, A, B, skip, out))
        print(f"[3] K-fwd {name:20s} {ho}^2 {ci}->{co}: max|err| {err:.3e} "
              f"({rel:.2e} of scale) kernel {ms:.4f} ms, device {dms:.4f} ms "
              f"({_tflops(flops, dms)}) plain {pms:.4f} ms (its cuDNN conv alone {cms:.4f} ms, "
              f"device {cdms:.4f} ms: {dms / cdms:.2f}x){_fmt(bd, dms)}")
        if rel > FWD_TOL:
            raise AssertionError(f"K-fwd {name} {ho}^2 {ci}->{co}: {rel:.3e} > {FWD_TOL}")
        res["conv3x3_fwd"]["err"] = max(res["conv3x3_fwd"]["err"], err)
        if (ho, ci, co, sk) == (256, 256, 256, True):
            res["conv3x3_fwd"].update(ms=ms, plain_ms=pms, library_ms=cms, **bd, device_ms=dms)
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
            dms = _device_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B))
            cdms = _device_ms(lambda: k3._conv_nhwc(g, wt))
            line = []
            for part, a, b in zip(("dx", "dA", "dB"), got, want):
                err, rel = _rel_max(a, b)
                line.append(f"{part} {err:.3e} ({rel:.2e})")
                if rel > DX_TOL:
                    raise AssertionError(f"K-dx {name} {ho}^2 {part}: {rel:.3e} > {DX_TOL}")
                res["conv3x3_dx"]["err"] = max(res["conv3x3_dx"]["err"], err)
            flops = 2 * ho * ho * 9 * ci * co
            bd = _bound(flops, _nbytes(g, wt, x, A, B, *got))
            print(f"[3] K-dx  {name:20s} {ho}^2 {ci}->{co}: {', '.join(line)} "
                  f"kernel {ms:.4f} ms, device {dms:.4f} ms ({_tflops(flops, dms)}) plain "
                  f"{pms:.4f} ms (its cuDNN conv alone {cms:.4f} ms, device {cdms:.4f} ms: "
                  f"{dms / cdms:.2f}x; bit-identical reruns){_fmt(bd, dms)}")
            if (ho, ci, co) == (256, 256, 256):
                res["conv3x3_dx"].update(ms=ms, plain_ms=pms, library_ms=cms, **bd, device_ms=dms)

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
        pms = _time_ms(lambda: k3.conv3x3_dx_plain(g, wt, x, A, B))
        cms = _time_ms(lambda: k3._conv_nhwc(g, wt))
        dms = _device_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B, wtiled=True))
        cdms = _device_ms(lambda: k3._conv_nhwc(g, wt))
        flops = 2 * 512 * 512 * 9 * ci * co
        bd = _bound(flops, _nbytes(g, wt, x, A, B, *got))
        print(f"[3] K-dx-w 512^2 {ci}->{co}: {', '.join(line)} kernel {ms:.4f} ms, device "
              f"{dms:.4f} ms ({_tflops(flops, dms)}; cuDNN's conv alone {cms:.4f} ms, device "
              f"{cdms:.4f} ms: {dms / cdms:.2f}x) plain {pms:.4f} ms (bit-identical reruns)"
              f"{_fmt(bd, dms)}")
        if (ci, co) == (128, 128):
            res["conv3x3_dx_wtiled"].update(ms=ms, plain_ms=pms, library_ms=cms, **bd,
                                            device_ms=dms)
    torch.cuda.synchronize()
    return res


def phase_kernels_f32(k3, dev) -> dict:
    """Phase 3: K-fwd f32 against its plain version (cuDNN in full f32) at
    the LPIPS VGG16's conv shapes at 256^2, each forward and its input
    gradient (the flipped, transposed conv; Cout 3 for the first), timed
    beside cuDNN's f32 conv with TF32 off and on. Returns the kernel's JSON
    entry for one guided step: the sums over its 39 launches (x_in's and the
    init image's forwards, x_in's input gradients)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(dev).manual_seed(99)
    res = {"err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "tf32_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
    for h, ci, co, n in VGG16_CONVS:
        for grad in (False, True):
            cin, cout = (co, ci) if grad else (ci, co)  # the input gradient: Cout -> Cin
            x = torch.randn(1, h, h, cin, generator=gen, device=dev)
            w = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * (9 * cin) ** -0.5
            bias = torch.zeros(cout, device=dev) if grad else torch.randn(
                cout, generator=gen, device=dev) * 0.1
            out = k3.conv3x3_fwd(x, w, bias)
            ref = k3.conv3x3_fwd_plain(x, w, bias)
            err, rel = _rel_max(out, ref)
            if rel > FWD_TOL:
                raise AssertionError(f"K-fwd f32 {h}^2 {cin}->{cout}: {rel:.3e} > {FWD_TOL}")
            exact = k3._conv_nhwc(x.double(), w.double()) + bias.double()
            f64 = (_rel_max(out.double(), exact)[1], _rel_max(ref.double(), exact)[1])
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)

            def cudnn():
                return F.conv2d(xn, wn, bias, padding=1)

            ms = _time_ms(lambda: k3.conv3x3_fwd(x, w, bias))
            dms = _device_ms(lambda: k3.conv3x3_fwd(x, w, bias))
            pms = _time_ms(lambda: k3.conv3x3_fwd_plain(x, w, bias))
            cms, cdms = _time_ms(cudnn), _device_ms(cudnn)
            torch.backends.cudnn.allow_tf32 = True
            try:
                tms, tdms = _time_ms(cudnn), _device_ms(cudnn)
            finally:
                torch.backends.cudnn.allow_tf32 = False
            flops = 2 * h * h * 9 * cin * cout
            nbytes = _nbytes(x, w, bias, out)
            bd = _bound(flops, nbytes, PEAK_TF32_FLOPS)
            print(f"[3] K-fwd f32 {'dx ' if grad else ''}{h}^2 {cin}->{cout} (x{n}): max|err| "
                  f"{err:.3e} ({rel:.2e} of scale; against f64 kernel {f64[0]:.2e}, cuDNN f32 "
                  f"{f64[1]:.2e}) kernel {ms:.4f} ms, device {dms:.4f} ms "
                  f"({_tflops(flops, dms)}) plain {pms:.4f} ms; cuDNN f32 {cms:.4f} ms, device "
                  f"{cdms:.4f} ms ({dms / cdms:.2f}x), cuDNN TF32 {tms:.4f} ms, device "
                  f"{tdms:.4f} ms ({dms / tdms:.2f}x){_fmt(bd, dms)}")
            res["err"] = max(res["err"], err)
            per_step = n * (1 if grad else 2)  # forwards of x_in and the init image
            for key, v in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                           ("library_ms", cms), ("tf32_ms", tdms),
                           ("t_ops", flops / PEAK_TF32_FLOPS * 1e3),
                           ("t_bytes", nbytes / PEAK_HBM_BYTES * 1e3)):
                res[key] += per_step * v
    torch.cuda.synchronize()
    res["bound_ms"] = max(res["t_ops"], res["t_bytes"])
    res["bound_by"] = "operations" if res["t_ops"] >= res["t_bytes"] else "bytes"
    print(f"[3] K-fwd f32, one guided step at 256^2 (39 launches): kernel {res['ms']:.4f} ms, "
          f"device {res['device_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, cuDNN f32 "
          f"{res['library_ms']:.4f} ms, cuDNN TF32 device {res['tf32_ms']:.4f} ms; bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
          f"({res['bound_ms'] / res['device_ms']:.1%} of it reached)")
    return res


def _sdpa_backend(q, k, v) -> str:
    """The backend F.scaled_dot_product_attention picks for these inputs:
    the first of its priority order that runs them."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in map(SDPBackend, torch._C._get_sdp_priority_order()):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(q, k, v)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def phase_attention(kattn, dev):
    """Phase 3: K-attn-f and K-attn-b against their plain versions, on the
    fused qkv [1, T, 3*N*d] the UNet gives them (N heads of batch 1), timed
    beside F.scaled_dot_product_attention (SDPA) on the same q, k, v (forward,
    and its backward alone): eager ms (CUDA events around 20 calls: the larger
    of host and device time), device ms (the kernels' own durations under
    torch.profiler) and host us per call (tools/attn_bench.py)."""
    import torch
    import torch.nn.functional as F

    from cgd_tpu_torch.tools.attn_bench import device_ms, host_us

    gen = torch.Generator(dev).manual_seed(4321)
    # (batch, N, T, d): the 64-512px UNets' d = 64 levels, then the 128px
    # model's d = 128 / 192 / 256 (4 heads at 512 / 768 / 1024 channels),
    # each timed; then ragged T and batches at d = 192 / 256 (held to the
    # plain version only)
    cases = [(1, 8, 1024, 64), (1, 16, 256, 64), (1, 16, 64, 64), (1, 4, 1024, 128),
             (1, 4, 256, 192), (1, 4, 64, 256), (1, 2, 77, 192), (2, 2, 45, 256),
             (2, 2, 300, 192), (1, 2, 200, 256)]
    res = {"attn_fwd": {"err": 0.0}, "attn_bwd": {"err": 0.0}}
    for bt, n, t, d in cases:
        qkv = torch.randn(bt, t, 3 * n * d, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(bt, t, n * d, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = kattn.split_heads(qkv, n)
        gh = kattn.to_heads(g, n)
        out, lse = kattn.attention_fwd(qkv, n)
        err, rel = _rel_max(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), bt))
        name = f"B{bt} N{n} T{t} d{d}"
        if rel > ATTN_TOL:
            raise AssertionError(f"K-attn-f {name}: {rel:.3e} > {ATTN_TOL}")
        res["attn_fwd"]["err"] = max(res["attn_fwd"]["err"], err)
        dqkv = kattn.attention_bwd(qkv, out, lse, g, n)
        if not torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, n)):
            raise AssertionError(f"K-attn-b {name}: repeated runs differ")
        line = []
        for part, a, b in zip(("dq", "dk", "dv"), dqkv.chunk(3, dim=-1),
                              kattn.attention_bwd_plain(q, k, v, gh)):
            e, r = _rel_max(a, kattn.merge_heads(b, bt))
            line.append(f"{part} {e:.3e} ({r:.2e})")
            if r > ATTN_TOL:
                raise AssertionError(f"K-attn-b {name} {part}: {r:.3e} > {ATTN_TOL}")
            res["attn_bwd"]["err"] = max(res["attn_bwd"]["err"], e)
        plan = kattn.attn_plan(bt, n, t, d)
        split = (f"D split {plan['cols']['fwd']} / dK,dV {plan['cols']['bwd_dkdv']}"
                 if plan["cols"] else f"tile split {plan['split']}")
        label = (f"{plan['body']} body, stages {tuple(plan['stages'].values())}, {split}, "
                 f"{plan['bwd_launches']} bwd launches")
        if bt > 1 or (n, t, d) in ((2, 77, 192), (2, 200, 256)):
            print(f"[3] K-attn {name} ({label}): fwd max|err| {err:.3e} ({rel:.2e}), "
                  f"{', '.join(line)} (bit-identical reruns)")
            continue
        # SDPA takes [batch, heads, T, d]; 3-D inputs send it to its math path
        q4, k4, v4, g4 = (z[None].contiguous() for z in (q, k, v, gh))
        sq, sk, sv = (z.detach().requires_grad_(True) for z in (q4, k4, v4))
        so = F.scaled_dot_product_attention(sq, sk, sv)
        fns = {
            "fwd": lambda: kattn.attention_fwd(qkv, n),
            "bwd": lambda: kattn.attention_bwd(qkv, out, lse, g, n),
            "sdpa_fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4),
            "sdpa_bwd": lambda: torch.autograd.grad(so, (sq, sk, sv), g4, retain_graph=True),
        }
        eager = {key: _time_ms(fn) for key, fn in fns.items()}
        dev_ms = {key: device_ms(fn)[0] for key, fn in fns.items()}
        host = {key: host_us(fn) for key, fn in fns.items()}
        fpms = _time_ms(lambda: kattn.attention_fwd_plain(q, k, v))
        bpms = _time_ms(lambda: kattn.attention_bwd_plain(q, k, v, gh))
        backend = _sdpa_backend(q4, k4, v4)
        flops_f, flops_b = 4 * n * t * t * d, 10 * n * t * t * d  # bwd: S recomputed, dV, dP, dQ, dK
        bdf = _bound(flops_f, _nbytes(qkv, out, lse))
        bdb = _bound(flops_b, _nbytes(qkv, out, lse, g, dqkv))
        print(f"[3] K-attn {name} ({label}): fwd max|err| {err:.3e} ({rel:.2e}), "
              f"{', '.join(line)} (bit-identical reruns; SDPA backend {backend})")
        for key, flops, bd, pms in (("fwd", flops_f, bdf, fpms), ("bwd", flops_b, bdb, bpms)):
            print(f"[3]   {key}: kernel device {dev_ms[key]:.4f} ms ({_tflops(flops, dev_ms[key])}, "
                  f"{bd['bound_ms'] / dev_ms[key]:.1%} of the bound), eager {eager[key]:.4f} ms, "
                  f"host {host[key]:.1f} us/call; SDPA {key} device {dev_ms['sdpa_' + key]:.4f} ms "
                  f"({dev_ms[key] / dev_ms['sdpa_' + key]:.2f}x), eager "
                  f"{eager['sdpa_' + key]:.4f} ms, host {host['sdpa_' + key]:.1f} us/call; "
                  f"plain {pms:.4f} ms{_fmt(bd)}")
        if (n, t, d) == (8, 1024, 64):
            res["attn_fwd"].update(ms=eager["fwd"], device_ms=dev_ms["fwd"], plain_ms=fpms,
                                   library_ms=eager["sdpa_fwd"], **bdf)
            res["attn_bwd"].update(ms=eager["bwd"], device_ms=dev_ms["bwd"], plain_ms=bpms,
                                   library_ms=eager["sdpa_bwd"], **bdb)
    torch.cuda.synchronize()
    return res


def _full_unet(dev, size: int):
    """The full-width class-conditional UNet at ``size`` px, random bf16
    conv weights with every zero-init conv re-drawn, and a probe input:
    (unet, n_params, run) where run(split=None) -> (output, input
    gradient)."""
    import torch

    from cgd_tpu_torch.models.unet import Conv, Dense, UNet, UNetConfig
    from cgd_tpu_torch.ops.nn import cast_conv_params
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

    def run(split=None):
        """Output and input gradient; ``split(x)`` -> a Split input."""
        x_ = x.clone().requires_grad_(True)
        out = unet(x_ if split is None else split(x_), t, y, compute_dtype=torch.bfloat16)
        out = out if split is None else out.gather()
        (g,) = torch.autograd.grad((out * probe).sum(), x_)
        return out.detach(), g

    return unet, n_params, run


def phase_unet(dev, size: int):
    """Phase 4: full-width UNet at ``size`` px, kernels vs plain routing."""
    import torch

    from cgd_tpu_torch.ops.nn import kernel_routing

    unet, n_params, run = _full_unet(dev, size)
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


def _lpips64(model, x, y):
    """``lpips_distance`` in f64 (which casts its inputs to f32): the exact
    reference the f32 routes are measured against."""
    import torch

    from cgd_tpu_torch.models.vgg_lpips import _SCALE, _SHIFT, vgg_taps

    shift, scale = (torch.tensor(v, dtype=torch.float64, device=x.device) for v in (_SHIFT, _SCALE))
    total = 0.0
    for tx, ty, lin in zip(vgg_taps(model, (x - shift) / scale),
                           vgg_taps(model, (y - shift) / scale), model.lins):
        nx = tx / (tx.square().sum(-1, keepdim=True).sqrt() + 1e-10)
        ny = ty / (ty.square().sum(-1, keepdim=True).sqrt() + 1e-10)
        total = total + ((nx - ny).square() @ lin.kernel[:, 0]).mean(dim=(1, 2))
    return total


def phase_lpips(k3, dev) -> None:
    """Phase 4: the full-width VGG16 LPIPS distance and its gradient with
    respect to x at 256^2, the convs on K-fwd f32 against
    ``kernel_routing("plain")`` (cuDNN in f32), random weights; both, and
    the plain routing with cuDNN's TF32, also against f64 (the plain
    routing on an f64 copy): the gradient's sensitivity to the convs'
    rounding."""
    import copy

    import torch

    from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS, lpips_distance
    from cgd_tpu_torch.ops.nn import kernel_routing

    model = VGGLPIPS(device=dev).init_weights(torch.Generator(dev).manual_seed(5))
    gen = torch.Generator(dev).manual_seed(6)
    x, y = (torch.rand(1, 256, 256, 3, generator=gen, device=dev) * 2 - 1 for _ in range(2))

    def run(fn=lpips_distance, m=model, dtype=torch.float32):
        x_ = x.to(dtype).clone().requires_grad_(True)
        d = fn(m, x_, y.to(dtype))
        return d.detach(), torch.autograd.grad(d.sum(), x_)[0]

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    k3.reset_launch_counts()
    got = run()
    launches = k3.LAUNCHES["conv3x3_fwd_f32"]
    with kernel_routing("plain"):
        want = run()
        exact = run(_lpips64, copy.deepcopy(model).double(), torch.float64)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = run()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    ms_k = _time_ms(run, iters=5)
    with kernel_routing("plain"):
        ms_p = _time_ms(run, iters=5)
    for i, name in enumerate(("distance", "d/dx")):
        a, b = got[i], want[i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"LPIPS {name}: non-finite values")
        print(f"[4] LPIPS VGG16 256^2 {name}: rel L2 err {rel(a, b):.3e} (|ref| "
              f"{b.norm().item():.3e}); against f64: kernels {rel(a, exact[i]):.3e}, plain "
              f"f32 {rel(b, exact[i]):.3e}, plain with cuDNN TF32 {rel(tf32[i], exact[i]):.3e}")
        if rel(a, b) > LPIPS_TOL:
            raise AssertionError(f"LPIPS {name}: rel L2 {rel(a, b):.3e} > {LPIPS_TOL}")
    if launches != 39:
        raise AssertionError(f"LPIPS distance + input gradient launched K-fwd f32 {launches} "
                             "times, not 39")
    print(f"[4] LPIPS VGG16 256^2 distance + input grad: kernels {ms_k:.2f} ms, plain routing "
          f"{ms_p:.2f} ms ({launches} K-fwd f32 launches)")


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


def phase_e2e(k3, kattn, dev, out_dir: Path, mesh=None, unsplit_step_s=None, size=256):
    """Phase 5: the 256px slice through the public generator, and the
    128px model at the API's defaults (``size=128``: head dims 128, 192 and
    256); phase 7c with ``mesh`` (no plain-routing runs). Returns (launches,
    s per step)."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.ops.nn import kernel_routing

    kwargs = dict(
        prompts=PROMPTS, image_size=size,
        num_cutouts=16, clip_model_name="ViT-B/32", timestep_respacing="ddim25",
        weights_mode="random", seed=0, device=str(dev), progress=False, mesh=mesh,
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
        if mesh is not None:
            _reset_launches(k3, kattn)
            step_s, total_s, paths = timed(12, out_dir)
            launches = _launches(k3, kattn)
        else:
            # the host-bound step varies from run to run: time the plain
            # routing before and after the kernels' run, in one process
            with kernel_routing("plain"):
                plain_before, _, _ = timed(12, out_dir / "plain", n_frames=2)
            frames.clear()
            _reset_launches(k3, kattn)
            step_s, total_s, paths = timed(12, out_dir)  # frames at steps 0, 12, 24
            launches = _launches(k3, kattn)
            by_d = {d: dict(n) for d, n in kattn.LAUNCHES_BY_D.items()}
            with kernel_routing("plain"):
                plain_after, _, _ = timed(12, out_dir / "plain", n_frames=2)
        final = frames[len(paths) - 1]
    finally:
        api.log_image = real_log_image

    if len(paths) != 3:
        raise AssertionError(f"expected frames at steps 0, 12, 24; got {paths}")
    if final.shape != (size, size, 3) or not np.isfinite(final).all():
        raise AssertionError(f"final frame: shape {final.shape}, finite {np.isfinite(final).all()}")
    _check_pngs((*paths, "current.png"))
    if mesh is not None:
        _check_launched(launches, ("conv3x3_fwd_halo", "attn_fwd", "attn_bwd"), "phase 7c")
        unsplit = {k: launches[k] for k in ("conv3x3_fwd", "conv3x3_dx", "conv3x3_dx_wtiled")}
        if any(unsplit.values()):
            raise AssertionError(f"phase 7c: the split UNet launched unsplit convs {unsplit}")
        print(f"[7c] 256px ddim25 guided sampling on {mesh}: {step_s * 1e3:.1f} ms per guided "
              f"step (phase 5, unsplit: {unsplit_step_s * 1e3:.1f} ms), {total_s:.2f} s per "
              f"image incl. model setup; launches {launches}; final frame |x|max "
              f"{np.abs(final).max():.3f}")
        return launches, step_s
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 5")
    # every head dim of the model on the Hopper bodies: d = 64 at 256px;
    # 128 / 192 / 256 at 128px (the 32^2 / 16^2 / 8^2 levels)
    for d in ((128, 192, 256) if size == 128 else (64,)):
        if kattn.attn_plan(1, 4, 64, d)["body"] != "wgmma":
            raise AssertionError(f"phase 5 {size}px: attention at d = {d} is not on the Hopper body")
        _check_launched(by_d[d], ("attn_fwd", "attn_bwd"), f"phase 5 {size}px, d = {d}")
    print(f"[5] {size}px ddim25 guided sampling: {step_s * 1e3:.1f} ms per guided step "
          f"(plain routing {plain_before * 1e3:.1f} ms before, {plain_after * 1e3:.1f} ms "
          f"after), {total_s:.2f} s per image incl. model setup; launches {launches}, "
          f"attention by head dim {({d: n for d, n in by_d.items() if any(n.values())})}; "
          f"final frame |x|max {np.abs(final).max():.3f}")
    return launches, step_s


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


def phase_halo(k3, dev):
    """Phase 7a: K-halo through kernels.conv_spmd on two shards of one card,
    forward and input gradient, against the plain version with autograd
    (conv3x3_fwd_halo_plain on the same boundary rows), at the shard shapes
    of the 256px and 512px UNets split in two."""
    import torch
    import torch.nn.functional as F

    from cgd_tpu_torch.kernels import conv_spmd

    gen = torch.Generator(dev).manual_seed(4242)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    # (name, shard H, W, cin, cout, prologue, skip): conv_in, a 256px
    # ResBlock out_conv, the 16^2 level's split-K conv, a 512px ResBlock conv
    cases = [
        ("conv3x3", 128, 256, 3, 256, False, False),
        ("conv3x3_gn_silu_add", 128, 256, 256, 256, True, True),
        ("conv3x3_gn_silu", 8, 16, 2048, 1024, True, False),
        ("conv3x3_gn_silu", 256, 512, 128, 128, True, False),
    ]
    res = {"err": 0.0}
    for name, hs, wd, ci, co, pro, sk in cases:
        xs = [rn(1, hs, wd, ci) for _ in range(2)]
        w = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
        bias = rn(co, scale=0.1)
        A = (1.0 + 0.2 * torch.randn(1, ci, generator=gen, device=dev)) if pro else None
        B = (0.2 * torch.randn(1, ci, generator=gen, device=dev)) if pro else None
        skips = [rn(1, hs, wd, co) for _ in range(2)] if sk else None
        gs = [rn(1, hs, wd, co) for _ in range(2)]

        def kernel(xs_):
            if not pro:
                return conv_spmd.conv3x3(xs_, w, bias)
            if sk:
                return conv_spmd.conv3x3_gn_silu_add(xs_, A, B, w, bias, skips)
            return conv_spmd.conv3x3_gn_silu(xs_, A, B, w, bias)

        def plain(xs_):
            return conv_spmd.conv3x3_shards_plain(xs_, w, bias, A, B, skips)

        line = []
        for label, fn in (("kernel", kernel), ("plain", plain)):
            xs_ = [x.clone().requires_grad_(True) for x in xs]
            outs = fn(xs_)
            dxs = torch.autograd.grad(outs, xs_, gs)
            if label == "kernel":
                got = (torch.cat(outs, 1).detach(), torch.cat(dxs, 1))
            else:
                want = (torch.cat(outs, 1).detach(), torch.cat(dxs, 1))
        for part, a, b in zip(("fwd", "dx"), got, want):
            err, rel = _rel_max(a, b)
            line.append(f"{part} {err:.3e} ({rel:.2e})")
            if rel > HALO_TOL:
                raise AssertionError(f"K-halo {name} {hs}x{wd} {ci}->{co} {part}: {rel:.3e} > "
                                     f"{HALO_TOL}")
            res["err"] = max(res["err"], err)
        # one shard's launch: K-halo, K-fwd on the same shard (zero pad), the
        # plain version, and cuDNN on the rows stacked with the halo
        x, skip = xs[1], None if skips is None else skips[1]
        act = x if A is None else conv_spmd._act_rows(x, A, B)
        etop = conv_spmd._act_rows(xs[0][:, -1:], A, B) if pro else xs[0][:, -1:].contiguous()
        ebot = torch.zeros_like(etop)
        ms = _time_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, etop=etop, ebot=ebot))
        fwd_ms = _time_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip))
        pms = _time_ms(lambda: k3.conv3x3_fwd_halo_plain(x, w, bias, A, B, skip, etop, ebot))
        stacked = torch.cat([etop, act, ebot], dim=1).permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1)
        cms = _time_ms(lambda: F.conv2d(stacked, w_oihw, padding=(0, 1)))
        out = k3.conv3x3_fwd(x, w, bias, A, B, skip, etop=etop, ebot=ebot)
        dms = _device_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, etop=etop, ebot=ebot))
        flops = 2 * hs * wd * 9 * ci * co
        bound = _bound(flops, _nbytes(x, w, bias, A, B, skip, etop, ebot, out))
        padded = ""
        if ci % k3.BK:  # the wrapper zero-pads x, w, etop and ebot to Cin 64 per call
            xp, wp, etp, ebp = (F.pad(z, (0, 0, 0, k3.BK - ci)) if z is w else
                                F.pad(z, (0, k3.BK - ci)) for z in (x, w, etop, ebot))
            padded = (f" (inputs padded to Cin {k3.BK} beforehand: K-halo "
                      f"{_time_ms(lambda: k3.conv3x3_fwd(xp, wp, bias, etop=etp, ebot=ebp)):.4f}"
                      f" ms, K-fwd {_time_ms(lambda: k3.conv3x3_fwd(xp, wp, bias)):.4f} ms)")
        print(f"[7a] K-halo {name:20s} shard {hs}x{wd} {ci}->{co}: {', '.join(line)}; kernel "
              f"{ms:.4f} ms, device {dms:.4f} ms ({_tflops(flops, dms)}; K-fwd on the shard "
              f"{fwd_ms:.4f} ms){padded} plain {pms:.4f} ms, cuDNN on the stacked rows "
              f"{cms:.4f} ms ({ms / cms:.2f}x){_fmt(bound, dms)}")
        if (hs, ci, co, sk) == (128, 256, 256, True):
            res.update(ms=ms, plain_ms=pms, library_ms=cms, **bound, device_ms=dms)
    torch.cuda.synchronize()
    return res


def phase_split_unet(dev):
    """Phase 7b: the full-width 512px UNet split in two on one card against
    the unsplit kernel UNet, forward and input gradient."""
    import torch

    from cgd_tpu_torch.parallel.mesh import make_mesh, split_activation

    unet, n_params, run = _full_unet(dev, 512)
    mesh = make_mesh([dev, dev])

    def split(x):
        return split_activation(x, mesh)

    out_u, g_u = run()
    out_s, g_s = run(split)
    ms_u = _time_ms(run, iters=3)
    ms_s = _time_ms(lambda: run(split), iters=3)
    for name, a, b in (("output", out_s, out_u), ("d/dx", g_s, g_u)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"split UNet {name}: non-finite values")
        rel = ((a - b).norm() / b.norm()).item()
        print(f"[7b] UNet 512px ({n_params / 1e6:.1f}M params) split cut=2 vs unsplit, {name}: "
              f"rel L2 err {rel:.3e}")
        if rel > UNET_TOL:
            raise AssertionError(f"split UNet 512px {name}: rel L2 {rel:.3e} > {UNET_TOL}")
    print(f"[7b] UNet 512px fwd + input grad: split cut=2 {ms_s:.2f} ms, unsplit {ms_u:.2f} ms")
    del unet
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the port's random weights written as the reference's checkpoints
# (the converters' name maps inverted: HWIO -> OIHW, [in, out] -> [out, in],
# scale -> weight, the attention qkv back to the legacy head-major order)
# ---------------------------------------------------------------------------

def _ref_conv(sd, p, name):
    sd[f"{name}.weight"] = p["kernel"].permute(3, 2, 0, 1).contiguous()
    if "bias" in p:
        sd[f"{name}.bias"] = p["bias"]


def _ref_linear(sd, p, name):
    sd[f"{name}.weight"] = p["kernel"].t().contiguous()
    sd[f"{name}.bias"] = p["bias"]


def _ref_norm(sd, p, name):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]


def _sub(flat: dict, prefix: str) -> dict:
    """The leaves under ``prefix.`` of a flat state dict, keys relative."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + ".")}


def unet_reference_sd(unet) -> dict:
    """A UNet of the port as the published guided-diffusion state dict
    (legacy attention order, as the 256px checkpoint)."""
    from cgd_tpu_torch.models.unet import block_plan

    cfg, flat, sd = unet.cfg, {k: v.cpu() for k, v in unet.state_dict().items()}, {}
    _ref_linear(sd, _sub(flat, "time_embed.0"), "time_embed.0")
    _ref_linear(sd, _sub(flat, "time_embed.1"), "time_embed.2")
    _ref_conv(sd, _sub(flat, "conv_in"), "input_blocks.0.0")
    input_plan, middle_plan, output_plan, _ = block_plan(cfg)

    def layer(key, name, spec):
        p = _sub(flat, key)
        if spec[0] == "res":
            _ref_norm(sd, _sub(p, "in_norm"), f"{name}.in_layers.0")
            _ref_conv(sd, _sub(p, "in_conv"), f"{name}.in_layers.2")
            _ref_linear(sd, _sub(p, "emb"), f"{name}.emb_layers.1")
            _ref_norm(sd, _sub(p, "out_norm"), f"{name}.out_layers.0")
            _ref_conv(sd, _sub(p, "out_conv"), f"{name}.out_layers.3")
            if "skip.kernel" in p:
                _ref_conv(sd, _sub(p, "skip"), f"{name}.skip_connection")
        elif spec[0] == "attn":
            ch, heads = spec[1], cfg.heads_for(spec[1])
            _ref_norm(sd, _sub(p, "norm"), f"{name}.norm")
            w, b = p["qkv.kernel"].t(), p["qkv.bias"]  # rows [q|k|v][h][d]
            sd[f"{name}.qkv.weight"] = (w.reshape(3, heads, ch // heads, ch).transpose(0, 1)
                                        .reshape(3 * ch, ch)[:, :, None].contiguous())
            sd[f"{name}.qkv.bias"] = b.reshape(3, heads, ch // heads).transpose(0, 1).reshape(-1)
            sd[f"{name}.proj_out.weight"] = p["proj.kernel"].t()[:, :, None].contiguous()
            sd[f"{name}.proj_out.bias"] = p["proj.bias"]
        else:
            _ref_conv(sd, _sub(p, "conv"), f"{name}.{'op' if spec[0] == 'downsample' else 'conv'}")

    for i, blk in enumerate(input_plan):
        for j, spec in enumerate(blk):
            layer(f"input.{i}.{j}", f"input_blocks.{i + 1}.{j}", spec)
    for j, spec in enumerate(middle_plan):
        layer(f"middle.{j}", f"middle_block.{j}", spec)
    for i, blk in enumerate(output_plan):
        for j, spec in enumerate(blk):
            layer(f"output.{i}.{j}", f"output_blocks.{i}.{j}", spec)
    _ref_norm(sd, _sub(flat, "out_norm"), "out.0")
    _ref_conv(sd, _sub(flat, "out_conv"), "out.2")
    if cfg.num_classes is not None:
        sd["label_emb.weight"] = flat["label_emb.table"]
    return sd


def clip_reference_sd(clip) -> dict:
    """A ViT CLIP of the port as OpenAI's CLIP state dict."""
    flat, sd = {k: v.cpu() for k, v in clip.state_dict().items()}, {}

    def block(p, name):
        _ref_norm(sd, _sub(p, "ln_1"), f"{name}.ln_1")
        sd[f"{name}.attn.in_proj_weight"] = p["attn_qkv.kernel"].t().contiguous()
        sd[f"{name}.attn.in_proj_bias"] = p["attn_qkv.bias"]
        _ref_linear(sd, _sub(p, "attn_out"), f"{name}.attn.out_proj")
        _ref_norm(sd, _sub(p, "ln_2"), f"{name}.ln_2")
        _ref_linear(sd, _sub(p, "mlp_fc"), f"{name}.mlp.c_fc")
        _ref_linear(sd, _sub(p, "mlp_proj"), f"{name}.mlp.c_proj")

    _ref_conv(sd, _sub(flat, "visual.conv1"), "visual.conv1")
    for k in ("class_embedding", "positional_embedding", "proj"):
        sd[f"visual.{k}"] = flat[f"visual.{k}"]
    _ref_norm(sd, _sub(flat, "visual.ln_pre"), "visual.ln_pre")
    _ref_norm(sd, _sub(flat, "visual.ln_post"), "visual.ln_post")
    for i in range(clip.cfg.vision.layers):
        block(_sub(flat, f"visual.blocks.{i}"), f"visual.transformer.resblocks.{i}")
    sd["token_embedding.weight"] = flat["text.token_embedding"]
    sd["positional_embedding"] = flat["text.positional_embedding"]
    sd["text_projection"] = flat["text.text_projection"]
    _ref_norm(sd, _sub(flat, "text.ln_final"), "ln_final")
    for i in range(clip.cfg.text.layers):
        block(_sub(flat, f"text.blocks.{i}"), f"transformer.resblocks.{i}")
    return sd


def lpips_reference_sds(model) -> tuple:
    """The port's LPIPS VGG16 as torchvision's vgg16 features and lpips'
    linear heads."""
    from cgd_tpu_torch.convert.torch_lpips import CONV_IDS

    flat = {k: v.cpu() for k, v in model.state_dict().items()}
    vgg = {}
    for i, cid in enumerate(CONV_IDS):
        _ref_conv(vgg, _sub(flat, f"convs.{i}"), f"features.{cid}")
    lin = {f"lin{i}.model.1.weight": flat[f"lins.{i}.kernel"][:, 0].reshape(1, -1, 1, 1)
           for i in range(5)}
    return vgg, lin


def _test_image(h: int, w: int, seed: int):
    """A smooth uint8 RGB test image (gradients and a disc)."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    rng = np.random.RandomState(seed)
    a, b, c = rng.rand(3) * 6
    disc = ((yy - 0.5) ** 2 + (xx - 0.5) ** 2 < 0.08).astype(np.float64)
    rgb = np.stack([np.sin(a * xx + b * yy), np.cos(c * yy) * (1 - disc), disc], -1)
    return ((rgb + 1) * 127.5).clip(0, 255).astype(np.uint8)


def phase_checkpoints(k3, kattn, dev, out_dir: Path, unsplit_step_s: float) -> dict:
    """Phase 8: the 256px init-image path from checkpoints in the reference
    layout. The port's random 256px UNet (zero-init convs re-drawn), CLIP
    ViT-B/32 and LPIPS VGG16 are written under the published file and key
    names into a temporary checkpoints_dir (the two LPIPS .pth files into
    the download cache the converter reads, pointed there), then
    ``api.clip_guided_diffusion(weights_mode="auto", ...)`` runs with an
    init image, skip 12 of ddim25, init_scale 1000 and an image prompt.
    Checks the .npz.cgd caches written and hit (the .pt files deleted, the
    weights resolved again bit-equal to the written ones), finite frames,
    the PNGs, 39 K-fwd f32 launches per guided step, and K-fwd, K-dx and the
    attention launched. Returns the launch counts of the run."""
    import shutil

    import numpy as np
    import torch

    from cgd_tpu_torch import api, weights
    from cgd_tpu_torch.convert import torch_lpips
    from cgd_tpu_torch.io_utils.images import encode_png
    from cgd_tpu_torch.models.clip import tokenizer
    from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS
    from cgd_tpu_torch.models.clip.model import CLIP
    from cgd_tpu_torch.models.unet import Conv, Dense, UNet, UNetConfig
    from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    ckpts = out_dir / "checkpoints"
    shutil.rmtree(out_dir, ignore_errors=True)
    (ckpts / "clip").mkdir(parents=True)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(8)
    info = DIFFUSION_LOOKUP["cond"][256]
    unet = UNet(UNetConfig.from_flags(info["model_flags"]), device="cpu").init_weights(gen)
    with torch.no_grad():  # re-draw every zero-init conv / projection, as phase 4
        for m in unet.modules():
            if isinstance(m, (Conv, Dense)) and m.zero:
                bound = 1.0 / float(torch.tensor(m.kernel.shape[:-1]).prod()) ** 0.5
                m.kernel.uniform_(-bound, bound, generator=gen)
    clip = CLIP(CLIP_CONFIGS["ViT-B/32"], device="cpu").init_weights(gen)
    lpips = VGGLPIPS(device="cpu").init_weights(gen)
    torch.save(unet_reference_sd(unet), ckpts / info["filename"])
    torch.save(clip_reference_sd(clip), ckpts / "clip" / "ViT-B-32.pt")
    vgg_sd, lin_sd = lpips_reference_sds(lpips)
    torch.save(vgg_sd, ckpts / "vgg16-397923af.pth")
    torch.save(lin_sd, ckpts / "lpips_vgg_v0.1.pth")
    (out_dir / "merges.txt").write_text("#version: tiny\n" + "\n".join(BPE_MERGES) + "\n")
    init_png, prompt_png = out_dir / "init.png", out_dir / "style.png"
    init_png.write_bytes(encode_png(_test_image(300, 260, 1)))
    prompt_png.write_bytes(encode_png(_test_image(224, 320, 2)))
    write_s = time.perf_counter() - t0

    frames, stamps, paths = [], [], []
    real_log_image, real_cache, real_tok = api.log_image, torch_lpips.CACHE_PATH, \
        tokenizer._DEFAULT_TOKENIZER

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    api.log_image = capture
    torch_lpips.CACHE_PATH = str(ckpts)  # where the LPIPS .pth files are looked up
    tokenizer._DEFAULT_TOKENIZER = tokenizer.SimpleTokenizer(
        str(out_dir / "merges.txt"), 256 + 2 + len(BPE_MERGES))
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        for _, path in api.clip_guided_diffusion(
                prompts=PROMPTS, image_prompts=[f"{prompt_png}:1"], init_image=str(init_png),
                skip_timesteps=12, init_scale=1000, image_size=256, num_cutouts=16,
                clip_model_name="ViT-B/32", timestep_respacing="ddim25", weights_mode="auto",
                checkpoints_dir=str(ckpts), seed=0, save_frequency=6, device=str(dev),
                prefix_path=out_dir / "outputs", progress=False):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            paths.append(path)
        launches = _launches(k3, kattn)
        peak = torch.cuda.max_memory_allocated(dev)
        total_s = time.perf_counter() - t0

        caches = [ckpts / f"{info['filename']}.npz.cgd", ckpts / "clip" / "ViT-B-32.pt.npz.cgd",
                  ckpts / "lpips_vgg.npz.cgd"]
        if not all(c.is_file() for c in caches):
            raise AssertionError(f"converted caches missing: {[str(c) for c in caches]}")
        for pt in (ckpts / info["filename"], ckpts / "clip" / "ViT-B-32.pt",
                   ckpts / "vgg16-397923af.pth", ckpts / "lpips_vgg_v0.1.pth"):
            pt.unlink()  # the second resolve can only hit the caches
        t1 = time.perf_counter()
        loaded = (weights.resolve_unet(256, True, "auto", device=dev, checkpoints_dir=str(ckpts))[0],
                  weights.resolve_clip("ViT-B/32", "auto", dev, str(ckpts))[0],
                  weights.resolve_lpips("auto", dev, str(ckpts)))
        hit_s = time.perf_counter() - t1
    finally:
        api.log_image, torch_lpips.CACHE_PATH = real_log_image, real_cache
        tokenizer._DEFAULT_TOKENIZER = real_tok
    for name, written, back in zip(("UNet", "CLIP", "LPIPS"), (unet, clip, lpips), loaded):
        a, b = written.state_dict(), back.state_dict()
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k].cpu()) for k in a):
            raise AssertionError(f"phase 8: the {name} read back from its cache is not the "
                                 "written one")
    del loaded
    steps = 25 - 12
    if len(paths) != 3 or len(frames) != 3:
        raise AssertionError(f"phase 8: expected frames at steps 0, 6, 12; got {paths}")
    if frames[-1].shape != (256, 256, 3) or not all(np.isfinite(f).all() for f in frames):
        raise AssertionError("phase 8: non-finite frames or a wrong shape")
    _check_pngs((*paths, "current.png"))
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 8")
    if launches["conv3x3_fwd_f32"] != 39 * steps:
        raise AssertionError(f"phase 8: K-fwd f32 launched {launches['conv3x3_fwd_f32']} times, "
                             f"not 39 x {steps} guided steps")
    step_s = (stamps[-1] - stamps[0]) / 12
    print(f"[8] 256px init image + skip 12 + init_scale 1000 + image prompt from reference-layout "
          f"checkpoints (ddim25, 13 guided steps): {step_s * 1e3:.1f} ms per guided step "
          f"(phase 5's 256px step without the init loss: {unsplit_step_s * 1e3:.1f} ms), "
          f"{total_s:.2f} s incl. conversion and model setup; checkpoints written in "
          f"{write_s:.1f} s, caches read back in {hit_s:.1f} s and bit-equal; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}; final frame |x|max "
          f"{np.abs(frames[-1]).max():.3f}")
    shutil.rmtree(out_dir, ignore_errors=True)
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
    lib = _build.library()
    print(f"[2] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")
    # what ptxas said of the attention kernels (their consumers must not spill)
    for line in _attn_ptxas(_build.ptxas_log()):
        print(f"[2] ptxas {line}")
    # the conv launches encode their TMA tensor maps on the host, per call
    buf = torch.empty(256 * 256 * 256, dtype=torch.bfloat16, device=dev)
    enc_s = lib.cgd_conv3x3_encode_seconds(buf.data_ptr(), 2000)
    if enc_s < 0:
        raise AssertionError("cuTensorMapEncodeTiled failed")
    print(f"[2] TMA tensor-map encode: {enc_s * 1e6:.2f} us of host time per conv launch "
          f"(four maps, as K-halo encodes; the most any launch does)")
    del buf

    from cgd_tpu_torch.parallel.mesh import make_mesh

    res = phase_kernels(k3, dev)
    res["conv3x3_fwd_f32"] = phase_kernels_f32(k3, dev)
    res.update(phase_attention(kattn, dev))
    res["conv3x3_fwd_halo"] = phase_halo(k3, dev)
    phase_unet(dev, 256)
    phase_unet(dev, 512)
    phase_unet(dev, 128)
    phase_lpips(k3, dev)
    phase_split_unet(dev)
    _, step_s = phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke")
    phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_128", size=128)
    launches = phase_cli(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_512")
    mesh_launches, _ = phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_mesh",
                                 mesh=make_mesh([dev, dev]), unsplit_step_s=step_s)
    launches["conv3x3_fwd_halo"] = mesh_launches["conv3x3_fwd_halo"]
    ckpt_launches = phase_checkpoints(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_ckpts",
                                      step_s)
    launches["conv3x3_fwd_f32"] = ckpt_launches["conv3x3_fwd_f32"]

    meta = {
        "conv3x3_fwd": ("cgd_tpu_torch/csrc/conv3x3_fwd.cu", "cgd_tpu/kernels/conv_pallas.py:364"),
        "conv3x3_fwd_halo": ("cgd_tpu_torch/csrc/conv3x3_fwd.cu",
                             "cgd_tpu/kernels/conv_pallas.py:364 (explicit_halo, via "
                             "cgd_tpu/kernels/conv_spmd.py:139)"),
        "conv3x3_dx": ("cgd_tpu_torch/csrc/conv3x3_dx.cu", "cgd_tpu/kernels/conv_pallas.py:779"),
        "conv3x3_dx_wtiled": ("cgd_tpu_torch/csrc/conv3x3_dx.cu",
                              "cgd_tpu/kernels/conv_pallas.py:680"),
        "attn_fwd": ("cgd_tpu_torch/csrc/attn_fwd.cu", "cgd_tpu/kernels/attention_pallas.py:69"),
        "attn_bwd": ("cgd_tpu_torch/csrc/attn_bwd.cu", "cgd_tpu/kernels/attention_pallas.py:82"),
        "conv3x3_fwd_f32": ("cgd_tpu_torch/csrc/conv3x3_f32.cu",
                            "cgd_tpu/kernels/conv_pallas.py:364 (f32, LPIPS VGG)"),
    }
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": res[name]["err"],
         **{k: res[name][k] for k in keys}}
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
