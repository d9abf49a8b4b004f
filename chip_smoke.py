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
   beside F.scaled_dot_product_attention's;
4. the full-width 256px, 512px and 128px class-conditional UNets (random
   weights, every zero-init conv re-drawn so the kernels' output reaches the
   result): forward and input gradient with the kernels against
   ``kernel_routing("plain")`` (bound: relative L2 error <= 5e-2 — two bf16
   routes that round at different points through ~60-90 convs and 16
   attention blocks; a wrong tap, halo or softmax gives O(1)); prints each
   run's peak device memory;
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
   reference's max), timed beside K-fwd on the same shard, the plain version
   and cuDNN on the concatenated input; (b) the full-width 512px UNet split
   in two against the unsplit kernel UNet, forward and input gradient
   (relative L2 <= 5e-2); (c) the 256px ViT-B/32 ddim25 guided run through
   ``api.clip_guided_diffusion(mesh=...)``, counters reset just before it
   and read just after: finite frames, PNGs, K-halo and attention launched,
   K-fwd and K-dx not.

Prints a JSON line of per-kernel results (launches from phase 6, K-halo's
from phase 7c; each with its eager and device time, its bound on the card
and the library call's time where there is one), and as its last line
``{"ok": true, "device": {...}}``.
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
PROMPTS = ["a watercolor painting of a lighthouse:1", "fog:0.5"]
# the least time of a kernel: NVIDIA's H100 SXM data sheet, dense bf16
# tensor-core rate and HBM3 bandwidth (at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


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


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the dense bf16 peak and the bytes (each input read once, each
    output written once) over the HBM bandwidth."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
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
              f"{ms:.4f} ms ({_tflops(flops, ms)}; K-fwd on the shard {fwd_ms:.4f} ms){padded} "
              f"plain {pms:.4f} ms, cuDNN on the stacked rows {cms:.4f} ms ({ms / cms:.2f}x)"
              f"{_fmt(bound, ms)}")
        if (hs, ci, co, sk) == (128, 256, 256, True):
            res.update(ms=ms, plain_ms=pms, library_ms=cms, **bound, device_ms=_device_ms(
                lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, etop=etop, ebot=ebot)))
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
    res.update(phase_attention(kattn, dev))
    res["conv3x3_fwd_halo"] = phase_halo(k3, dev)
    phase_unet(dev, 256)
    phase_unet(dev, 512)
    phase_unet(dev, 128)
    phase_split_unet(dev)
    _, step_s = phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke")
    phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_128", size=128)
    launches = phase_cli(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_512")
    mesh_launches, _ = phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_mesh",
                                 mesh=make_mesh([dev, dev]), unsplit_step_s=step_s)
    launches["conv3x3_fwd_halo"] = mesh_launches["conv3x3_fwd_halo"]

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
