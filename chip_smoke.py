#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (cgd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:
1. require a CUDA card; print ``nvidia-smi --query-gpu=name,power.limit``;
2. build the hand-written kernels from ``cgd_tpu_torch/csrc`` (nvcc, one
   process per source, in parallel), print what ptxas said of each
   attention kernel and of the f32 conv body (registers, spill bytes, wgmma
   serialization), and time the host's TMA tensor-map encode that every
   conv launch makes. Every device time below is held against the same
   call's CUDA-event time (``_checked``): one that falls far under it is
   measured again in a fresh process (``tools/conv_bench.py`` /
   ``tools/attn_bench.py``) and marked ``*`` if it still does, and the
   marked readings are listed at the end;
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
   cutouts, ViT-B/32, ddim25, random weights with the UNet's zero-init
   layers re-drawn (else its output is exactly 0), the launch counters reset
   just before it and read just after, between two short runs under the
   plain routing for its step time; checks the first guided step's x
   against the plain routing's from the same seed (relative L2 <=
   BF16_STEP_TOL), finite frames, written PNGs and that every kernel of the
   path launched; then the same at the API's default
   size, the 128px model (attention at d = 128, 192 and 256), checking that
   the attention launched at each of the three head dims;
6. the 512px path through the CLI, ``cgd_tpu_torch.cli.main``: 512px
   class-conditional ADM guided by CLIP RN50x16, 16 cutouts, ddim25, random
   weights, with the same checks (the first step's x against the CLI's
   under the plain routing, interrupted after that step), the step time of
   the plain routing before and after it, and the run's peak device memory;
7. the height-split mesh path on the one card, ``make_mesh([dev, dev])``
   (cut=2, shards run one after the other): (a) K-halo through
   ``kernels.conv_spmd``, forward and input gradient, against its plain
   version at the shard shapes of the 256px and 512px UNets (bound 1% of the
   reference's max), timed (CUDA events and device time) beside K-fwd on
   the same shard, the plain version and cuDNN on the concatenated input
   (eager and device); (b) the full-width 512px UNet split
   in two against the unsplit kernel UNet, forward and input gradient
   (relative L2 <= 5e-2); (c) the 256px ViT-B/32 ddim25 guided run through
   ``api.clip_guided_diffusion(mesh=...)``, counters reset just before it
   and read just after: the first step's x against the plain routing's on
   the same mesh, finite frames, PNGs, K-halo and attention launched, K-fwd
   and K-dx not;
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
   deleted after;
9. ``compute_dtype="float32"`` on the card, every line with the card's name
   and power limit: (a) K-fwd f32 in its prologue, residual and up modes at
   phase 3's UNet shapes, K-dx f32 at 256^2, 16^2 and the W >= 512 class
   at 512^2, K-attn-f / K-attn-b f32 at the six shapes the main paths
   launch (timed beside SDPA f32, its backend named) and ragged T, each
   against its plain version in f32 (bound 1e-5 of the reference's max) and
   against f64 beside the plain version's own error, K-fwd f32 (split K
   included), K-dx f32 and K-attn-b f32 bit-identical over two runs, timed
   beside cuDNN f32 (TF32 off) or SDPA at f32, each conv with its
   ``f32_plan`` (tile, patch, split K, shape class); (b) the full 256px, 128px and 512px UNets at f32,
   kernels vs ``kernel_routing("plain")`` (relative L2 <= 1e-4), the 128px
   one with the f32 attention at d = 128, 192 and 256, the 512px one with
   K-dx f32's W >= 512 class; (c) the 256px ViT-B/32 ddim25
   run through ``api.clip_guided_diffusion(compute_dtype="float32")``: the
   first guided step's x vs the plain routing from the same seed (relative
   L2 <= 1e-3), finite frames, PNGs, peak memory, ms per step beside phase
   5's, counters reset just before and read just after: every f32 kernel
   launched and no bf16 kernel;
10. the height-split mesh at ``compute_dtype="float32"`` on the one card,
   every line with the card's name and power limit: (a) K-halo f32 through
   ``kernels.conv_spmd`` on two shards, forward and input gradient, against
   its plain version with autograd (bound 1e-5 of the reference's max) and
   against f64, at phase 7a's shard shapes and the 8^2 level's 4- and 2-row
   shards, bit-identical over two runs, timed beside cuDNN f32 on the
   stacked rows, K-fwd f32 on the shard and the plain version; (b) the full 256px UNet at f32 split cut=2
   against the unsplit f32 kernel UNet (relative L2 <= 1e-4), launching
   K-halo f32 and no other conv kernel; (c) phase 9c's run through
   ``api.clip_guided_diffusion(mesh=make_mesh([dev, dev]),
   compute_dtype="float32")``, counters reset just before and read just
   after: first step's x vs the plain routing on the same mesh, frames,
   PNGs, K-halo f32 and the f32 attention launched, no bf16 kernel and no
   unsplit f32 conv, ms per step beside phases 9c and 7c; (d) the CLI with
   ``--mesh cut=2 --compute-dtype float32`` over two copies of the card;
12. the 64px model and the sampler's options, every line with the card's
   name and power limit: (a) the bf16 K-fwd (plain, prologue, prologue +
   residual, up) and K-dx at the 64px model's shapes, where Cout / Cx 192,
   384 and 576 fill their 256-wide N tiles partly (each row with its dead
   columns), and the attention at its 6 / 9 / 12 heads of d = 64, against
   their plain versions as in phase 3, timed beside cuDNN / SDPA; the full
   64px UNet, forward and input gradient, bf16 against the plain routing
   (UNET_TOL) and f32 (F32_UNET_TOL); (b) a 64px ddim25 run through the API
   with ``use_augs`` (numpy-drawn augmentations, the same in both runs) and
   the zero-init layers re-drawn: the 64px magnitude line, the first step's
   x against the plain routing's (BF16_STEP_TOL), the step time, s per
   image and launches (the attention's by head dim); (c) phase 5's 256px
   run with ``fast_guidance``: no K-dx, K-dx-w or K-attn-b launch (bf16 or
   f32), the first step's x against the plain routing's fast step, its step
   time and peak memory beside phase 5's; (d) the 256px run with
   ``dpm_solver``: finite frames, its first step equal to a DDIM eta = 0
   step from the same state (relative L2 <= 1e-5); (e) the CLI at 128px with
   ``-reduce -cutn_skip -cached_cutn -ht 0 -wd 64`` (128 x 192): the frames'
   shape and the guided steps against the step plan; (f) a 64px ddim5 run's
   noise recorded and replayed through ``noise_file``: equal frames
   (within 1e-6 relative);
13. resume, the serving daemon and the rest of the CLI, every line with the
   card's name and power limit, the zero-init layers re-drawn: (a) resume
   at 256px bf16, ddim10, save_frequency 3, through the API: runs A and C
   uninterrupted, run B closed after its second frame and resumed from its
   checkpoint, and a control resumed with its generator state overwritten
   by a fresh ``manual_seed``; max |A - C| and max |A - resumed B| over the
   final frame and x (bit-equal where A and C are, else within |A - C|; the
   control must differ by more), the checkpoint's bytes and the host ms a
   segment its write takes; (b) the same at 128px with DPM-Solver++(2M)
   (x0p across the checkpoint), whose checkpoint a run without
   ``dpm_solver`` refuses; (c) ``cgd_tpu_torch.serve`` in a thread on a
   free port (``--warmup 128:ddim10:16 --stall-timeout 600``): healthz,
   two lone then two overlapping 128px ddim10 requests (plain, and a
   stream at save_frequency 5) each held to a direct API run, an f32
   request overlapping a bf16 one (within rel L2 1e-3 of a lone f32 run,
   no bf16 kernel among its launches, with PyTorch's default TF32 flags in
   the process), 400 without a prompt on both paths, and a request on a
   second daemon with ``--mesh cut=2`` over the card twice launching
   K-halo; (d) ``cli.main`` at 128px ddim10 with ``-gif -mp4 --log-losses
   --profile DIR --checkpoint P`` (a mux each, frames deleted only if both
   wrote, a trace naming a ``cgd::`` kernel, one loss line per guided
   step), then interrupted after its fourth frame and ``--resume``d: the
   last frame held to the uninterrupted run's.

Prints a JSON line of per-kernel results (launches from phase 6, K-halo's
from phase 7c, K-fwd f32's from phase 8, K-dx f32's and the f32
attention's from phase 9c, K-halo f32's from phase 10c; each with its eager
and device time, its bound on the card and the library call's time where
there is one; K-fwd f32's summed over one guided step's 39 launches), the
whole run's wall time, and as its last line ``{"ok": true, "device":
{...}}``.
Needs one card; builds everything it runs.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FWD_TOL = DX_TOL = ATTN_TOL = HALO_TOL = 1e-2  # max |err| / max |ref|
UNET_TOL = 5e-2                                # relative L2 error, full UNet
LPIPS_TOL = 1e-2                               # relative L2 error, full VGG16 LPIPS
F32_TOL = 1e-5        # max |err| / max |ref|, the f32 kernels against their plain versions
F32_UNET_TOL = 1e-4   # relative L2 error, the full UNets at compute_dtype float32
F32_STEP_TOL = 1e-3   # relative L2 error, the first f32 guided step's x
# relative L2 error, the first bf16 guided step's x (phases 5, 6, 7c), kernels
# against the plain routing from the same seed: at the first ddim25 step x is
# almost all the UNet's eps (pred_x0 is clipped, sqrt(1 - alpha_bar) ~ 1), and
# the bf16 UNet's output is held to UNET_TOL in phase 4
BF16_STEP_TOL = UNET_TOL
CARD = "card not read yet"  # nvidia-smi's name and power limit, set by main()
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
# phase 10a's K-halo f32 shards (name, shard H, W, Cin, Cout, prologue,
# skip): phase 7a's four (conv_in, a 256px ResBlock out_conv, the 16^2
# level's 2048 -> 1024, a 512px ResBlock conv), then a 256px 8^2-level
# ResBlock out_conv split cut=2 and cut=4 (shards shorter than a patch)
HALO_F32_SHARDS = [
    ("conv3x3", 128, 256, 3, 256, False, False),
    ("conv3x3_gn_silu_add", 128, 256, 256, 256, True, True),
    ("conv3x3_gn_silu", 8, 16, 2048, 1024, True, False),
    ("conv3x3_gn_silu", 256, 512, 128, 128, True, False),
    ("conv3x3_gn_silu_add", 4, 8, 1024, 1024, True, True),
    ("conv3x3_gn_silu_add", 2, 8, 1024, 1024, True, True),
]
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


MARKED = []  # device readings that fell far under their CUDA-event time, fresh process too


def _checked(fn, fresh=None, label: str = ""):
    """(device ms, kernels per call, mark) of ``fn``: the durations of the
    kernels it launches, summed under torch.profiler over 20 calls, held
    against the same call's CUDA-event time with the calls queued back to
    back (attn_bench.checked_device_ms).
    A reading that falls far under it, or that the profiler did not record
    at all (nan), is measured again in a fresh process by ``fresh``
    (tools/conv_bench.py or tools/attn_bench.py on the same shape), and
    marked "*" (printed, and listed at the end) if it still does."""
    from cgd_tpu_torch.tools.attn_bench import checked_device_ms

    dms, kernels, mark, queued, host = checked_device_ms(fn, fresh)
    if mark:
        print(f"[device time] {label}: {dms:.4f} ms against {queued:.4f} ms by events (calls "
              f"queued), host {host:.1f} us per call: "
              f"{'a fresh process reads it' if mark == 'fresh' else 'marked *'}")
    if mark == "*":
        MARKED.append(f"{label} {dms:.4f} ms (events {queued:.4f} ms)")
    return dms, kernels, mark


def _device_ms(fn, fresh=None, label: str = "") -> float:
    """Device ms per call of ``fn`` (``_checked``)."""
    return _checked(fn, fresh, label)[0]


def _conv_fresh(key: str, call: str = "kernel"):
    """A fresh process's device time of conv_bench's row ``key``."""
    from cgd_tpu_torch.tools import conv_bench

    return lambda: conv_bench.fresh(str(ROOT), key, call)


def _attn_fresh(n: int, t: int, d: int, name: str, dtype: str):
    """A fresh process's device time of attn_bench's call at (n, t, d)."""
    from cgd_tpu_torch.tools import attn_bench

    return lambda: attn_bench.fresh_ms(attn_bench.__file__, str(ROOT), f"{n},{t},{d},{name}",
                                       "--dtype", dtype)


def _attn_ptxas(log: str, namespaces=("attn", "attn32")) -> list:
    """Per kernel of the build (nvcc -Xptxas -v) in ``namespaces`` (by
    default the attention's, bf16 ``cgd::attn`` and f32 ``cgd::attn32``;
    phase 2 also asks for the f32 conv body's ``cgd::f32conv``): its
    registers, spill bytes, and any wgmma serialization warning (C7512 /
    C7513). The mangled name ``_ZN3cgd<n><namespace><m><function>...`` is
    read by its lengths."""
    import re

    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(_ZN3cgd(\d+)(\w+))'", line)
        if not m:
            continue
        mangled, rest = m.group(1), m.group(3)
        ns, rest = rest[:int(m.group(2))], rest[int(m.group(2)):]
        fn = re.match(r"(\d+)", rest)
        if ns not in namespaces or not fn:
            continue
        name = rest[len(fn.group(1)):][:int(fn.group(1))]
        tmpl = re.match(r"I((?:L[ib]\d+E)+)E", rest[len(fn.group(1)) + len(name):])
        info = " ".join(x.strip() for x in lines[i + 1:i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
        regs = re.search(r"Used (\d+) registers", info)
        warn = sorted({w for w in re.findall(r"\((C751\d)\)[^']*'" + mangled, log)})
        args = ", ".join(re.findall(r"L[ib](\d+)E", tmpl.group(1))) if tmpl else ""
        out.append(f"{ns}::{name}{f'<{args}>' if tmpl else ''}: "
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


# phase 3's bf16 conv shapes (name, out H = W, cin, cout, prologue, skip,
# up; for up, H is the output): the 256px and 512px UNets' classes
CONV_CASES = [
    ("conv3x3", 256, 3, 256, False, False, False),
    ("conv3x3_gn_silu_add", 256, 256, 256, True, True, False),
    ("conv3x3_gn_silu_add", 512, 128, 128, True, True, False),
    ("conv3x3_gn_silu_up", 128, 512, 512, True, False, True),
    ("conv3x3_gn_silu", 16, 2048, 1024, True, False, False),
    ("conv3x3_gn_silu", 256, 256, 6, True, False, False),
]
# phase 12a's: the 64px model's, where Cout 192 / 384 / 576 fill their N
# tiles of 256 partly (K-dx at Cx = 192 / 384 / 576 too); then the 128px
# model's at phase 12e's 128 x 192 sample, whose maps are not square (out
# (H, W) for those)
CONV_CASES_64 = [
    ("conv3x3", 64, 3, 192, False, False, False),
    ("conv3x3_gn_silu_add", 64, 192, 192, True, True, False),
    ("conv3x3_gn_silu", 32, 192, 384, True, False, False),
    ("conv3x3_gn_silu_add", 32, 384, 384, True, True, False),
    ("conv3x3_gn_silu_add", 16, 576, 576, True, True, False),
    ("conv3x3_gn_silu_add", 8, 768, 768, True, True, False),
    ("conv3x3_gn_silu_up", 16, 768, 768, True, False, True),
    ("conv3x3_gn_silu_up", 32, 576, 576, True, False, True),
    ("conv3x3_gn_silu", 64, 192, 6, True, False, False),
    ("conv3x3_gn_silu_add", (128, 192), 256, 256, True, True, False),
    ("conv3x3_gn_silu_up", (64, 96), 512, 512, True, False, True),
    ("conv3x3_gn_silu_add", (8, 12), 1024, 1024, True, True, False),
]


def _dead_columns(k3, oh, ow, ci, co, up) -> str:
    """The share of the N tiles' columns past Cout (work the conv does and
    throws away), from conv_plan."""
    plan = k3.conv_plan(1, oh // 2 if up else oh, ow // 2 if up else ow, ci, co, up=up)
    cols = plan["grid"][1] * plan["bn"]
    return f"N tiles {plan['grid'][1]} x {plan['bn']}, {(cols - co) / cols:.0%} dead columns"


def _rn(gen, dev):
    """rn(*shape, scale=1.0, dtype=bf16): normal draws from ``gen`` on ``dev``."""
    import torch

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    return rn


def phase_kernels(k3, dev, cases=CONV_CASES, tag="3"):
    """Phase 3 (12a with the 64px ``cases``): K-fwd and K-dx against their
    plain versions at the path's shapes (out H = W, or out (H, W))."""
    import torch

    gen = torch.Generator(dev).manual_seed(1234)
    rn = _rn(gen, dev)
    res = {"conv3x3_fwd": {"err": 0.0}, "conv3x3_dx": {"err": 0.0}}
    for name, ho, ci, co, pro, sk, up in cases:
        oh, ow = ho if isinstance(ho, tuple) else (ho, ho)
        side = f"{oh}^2" if oh == ow else f"{oh}x{ow}"
        x = rn(1, oh // 2, ow // 2, ci) if up else rn(1, oh, ow, ci)
        w = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
        bias = rn(co, scale=0.1)
        A = (1.0 + 0.2 * torch.randn(1, ci, generator=gen, device=dev)) if pro else None
        B = (0.2 * torch.randn(1, ci, generator=gen, device=dev)) if pro else None
        skip = rn(1, oh, ow, co) if sk else None
        out = k3.conv3x3_fwd(x, w, bias, A, B, skip, up)
        ref = k3.conv3x3_fwd_plain(x, w, bias, A, B, skip, up)
        err, rel = _rel_max(out, ref)
        ms = _time_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, up))
        pms = _time_ms(lambda: k3.conv3x3_fwd_plain(x, w, bias, A, B, skip, up))
        # the bare cuDNN conv on the conv's actual (activated, upsampled) input
        h = x if A is None else k3._silu_chain(x, A, B)[2].to(x.dtype)
        h = k3._up2(h) if up else h
        cms = _time_ms(lambda: k3._conv_nhwc(h, w))
        dms = _device_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, up),
                         label=f"K-fwd {name} {side} {ci}->{co}")
        cdms = _device_ms(lambda: k3._conv_nhwc(h, w), label=f"cuDNN {side} {ci}->{co}")
        flops = 2 * oh * ow * 9 * ci * co
        bd = _bound(flops, _nbytes(x, w, bias, A, B, skip, out))
        print(f"[{tag}] K-fwd {name:20s} {side} {ci}->{co}: max|err| {err:.3e} "
              f"({rel:.2e} of scale) kernel {ms:.4f} ms, device {dms:.4f} ms "
              f"({_tflops(flops, dms)}) plain {pms:.4f} ms (its cuDNN conv alone {cms:.4f} ms, "
              f"device {cdms:.4f} ms: {dms / cdms:.2f}x){_fmt(bd, dms)}; "
              f"{_dead_columns(k3, oh, ow, ci, co, up)}")
        if rel > FWD_TOL:
            raise AssertionError(f"K-fwd {name} {side} {ci}->{co}: {rel:.3e} > {FWD_TOL}")
        res["conv3x3_fwd"]["err"] = max(res["conv3x3_fwd"]["err"], err)
        if (ho, ci, co, sk) == (256, 256, 256, True):
            res["conv3x3_fwd"].update(ms=ms, plain_ms=pms, library_ms=cms, **bd, device_ms=dms)
        if pro and not up:
            g = rn(1, oh, ow, co)
            wt = k3._flip_t(w)
            got = k3.conv3x3_dx(g, wt, x, A, B)
            want = k3.conv3x3_dx_plain(g, wt, x, A, B)
            again = k3.conv3x3_dx(g, wt, x, A, B)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K-dx {name} {side}: repeated runs differ")
            ms = _time_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B))
            pms = _time_ms(lambda: k3.conv3x3_dx_plain(g, wt, x, A, B))
            cms = _time_ms(lambda: k3._conv_nhwc(g, wt))
            dms = _device_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B), label=f"K-dx {name} {side}")
            cdms = _device_ms(lambda: k3._conv_nhwc(g, wt), label=f"cuDNN dx {name} {side}")
            line = []
            for part, a, b in zip(("dx", "dA", "dB"), got, want):
                err, rel = _rel_max(a, b)
                line.append(f"{part} {err:.3e} ({rel:.2e})")
                if rel > DX_TOL:
                    raise AssertionError(f"K-dx {name} {side} {part}: {rel:.3e} > {DX_TOL}")
                res["conv3x3_dx"]["err"] = max(res["conv3x3_dx"]["err"], err)
            flops = 2 * oh * ow * 9 * ci * co
            bd = _bound(flops, _nbytes(g, wt, x, A, B, *got))
            print(f"[{tag}] K-dx  {name:20s} {side} {ci}->{co}: {', '.join(line)} "
                  f"kernel {ms:.4f} ms, device {dms:.4f} ms ({_tflops(flops, dms)}) plain "
                  f"{pms:.4f} ms (its cuDNN conv alone {cms:.4f} ms, device {cdms:.4f} ms: "
                  f"{dms / cdms:.2f}x; bit-identical reruns){_fmt(bd, dms)}; "
                  f"Cx {ci}: {_dead_columns(k3, oh, ow, co, ci, False)}")
            if (ho, ci, co) == (256, 256, 256):
                res["conv3x3_dx"].update(ms=ms, plain_ms=pms, library_ms=cms, **bd, device_ms=dms)
    torch.cuda.synchronize()
    return res


def phase_dx_wtiled(k3, dev) -> dict:
    """Phase 3: K-dx-w against its plain version at the 512px UNet's
    full-resolution classes (forward Cin -> Cout)."""
    import torch

    gen = torch.Generator(dev).manual_seed(1235)
    rn = _rn(gen, dev)
    res = {"err": 0.0}
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
            res["err"] = max(res["err"], err)
        ms = _time_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B, wtiled=True))
        pms = _time_ms(lambda: k3.conv3x3_dx_plain(g, wt, x, A, B))
        cms = _time_ms(lambda: k3._conv_nhwc(g, wt))
        dms = _device_ms(lambda: k3.conv3x3_dx(g, wt, x, A, B, wtiled=True),
                         label=f"K-dx-w 512^2 {ci}->{co}")
        cdms = _device_ms(lambda: k3._conv_nhwc(g, wt), label=f"cuDNN dx 512^2 {ci}->{co}")
        flops = 2 * 512 * 512 * 9 * ci * co
        bd = _bound(flops, _nbytes(g, wt, x, A, B, *got))
        print(f"[3] K-dx-w 512^2 {ci}->{co}: {', '.join(line)} kernel {ms:.4f} ms, device "
              f"{dms:.4f} ms ({_tflops(flops, dms)}; cuDNN's conv alone {cms:.4f} ms, device "
              f"{cdms:.4f} ms: {dms / cdms:.2f}x) plain {pms:.4f} ms (bit-identical reruns)"
              f"{_fmt(bd, dms)}")
        if (ci, co) == (128, 128):
            res.update(ms=ms, plain_ms=pms, library_ms=cms, **bd, device_ms=dms)
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
            tag = f"{h}^2 {cin}->{cout}{' dx' if grad else ''}"
            dms = _device_ms(lambda: k3.conv3x3_fwd(x, w, bias), label=f"K-fwd f32 VGG {tag}")
            pms = _time_ms(lambda: k3.conv3x3_fwd_plain(x, w, bias))
            cms, cdms = _time_ms(cudnn), _device_ms(cudnn, label=f"cuDNN f32 {tag}")
            torch.backends.cudnn.allow_tf32 = True
            try:
                tms, tdms = _time_ms(cudnn), _device_ms(cudnn, label=f"cuDNN TF32 {tag}")
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


# phase 3's attention shapes (batch, N, T, d): the 64-512px UNets' d = 64
# levels, then the 128px model's d = 128 / 192 / 256 (4 heads at 512 / 768 /
# 1024 channels), each timed; then ragged T and batches at d = 192 / 256
# (held to the plain version only)
ATTN_CASES = [(1, 8, 1024, 64), (1, 16, 256, 64), (1, 16, 64, 64), (1, 4, 1024, 128),
              (1, 4, 256, 192), (1, 4, 64, 256), (1, 2, 77, 192), (2, 2, 45, 256),
              (2, 2, 300, 192), (1, 2, 200, 256)]
# phase 12a's: the 64px model's 6 / 9 / 12 heads of d = 64 at 32^2 / 16^2 / 8^2;
# then the 128px model's at phase 12e's 128 x 192 sample (T = 32 x 48, 16 x
# 24, 8 x 12)
ATTN_CASES_64 = [(1, 6, 1024, 64), (1, 9, 256, 64), (1, 12, 64, 64), (1, 4, 1536, 128),
                 (1, 4, 384, 192), (1, 4, 96, 256)]
# (N, T, d) held to the plain version only, not timed
ATTN_UNTIMED = {(2, 77, 192), (2, 200, 256), (4, 1536, 128), (4, 384, 192), (4, 96, 256)}


def phase_attention(kattn, dev, cases=ATTN_CASES, tag="3"):
    """Phase 3 (12a with the 64px ``cases``): K-attn-f and K-attn-b against
    their plain versions, on the fused qkv [1, T, 3*N*d] the UNet gives them
    (N heads of batch 1), timed (but for ATTN_UNTIMED) beside
    F.scaled_dot_product_attention (SDPA) on the same q, k, v (forward, and
    its backward alone): eager ms (CUDA events around 20 calls: the larger
    of host and device time), device ms (the kernels' own durations under
    torch.profiler) and host us per call (tools/attn_bench.py)."""
    import torch
    import torch.nn.functional as F

    from cgd_tpu_torch.tools.attn_bench import host_us

    gen = torch.Generator(dev).manual_seed(4321)
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
        if bt > 1 or (n, t, d) in ATTN_UNTIMED:
            print(f"[{tag}] K-attn {name} ({label}): fwd max|err| {err:.3e} ({rel:.2e}), "
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
        bench = {"fwd": "K-attn-f", "bwd": "K-attn-b", "sdpa_fwd": "SDPA fwd",
                 "sdpa_bwd": "SDPA bwd"}
        dev_ms = {key: _device_ms(fn, _attn_fresh(n, t, d, bench[key], "bfloat16")
                                  if bt == 1 else None, f"{bench[key]} {name}")
                  for key, fn in fns.items()}
        host = {key: host_us(fn) for key, fn in fns.items()}
        fpms = _time_ms(lambda: kattn.attention_fwd_plain(q, k, v))
        bpms = _time_ms(lambda: kattn.attention_bwd_plain(q, k, v, gh))
        backend = _sdpa_backend(q4, k4, v4)
        flops_f, flops_b = 4 * n * t * t * d, 10 * n * t * t * d  # bwd: S recomputed, dV, dP, dQ, dK
        bdf = _bound(flops_f, _nbytes(qkv, out, lse))
        bdb = _bound(flops_b, _nbytes(qkv, out, lse, g, dqkv))
        print(f"[{tag}] K-attn {name} ({label}): fwd max|err| {err:.3e} ({rel:.2e}), "
              f"{', '.join(line)} (bit-identical reruns; SDPA backend {backend})")
        for key, flops, bd, pms in (("fwd", flops_f, bdf, fpms), ("bwd", flops_b, bdb, bpms)):
            print(f"[{tag}]   {key}: kernel device {dev_ms[key]:.4f} ms "
                  f"({_tflops(flops, dev_ms[key])}, "
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


def _redraw_zero_init(unet, gen) -> None:
    """Re-draw every zero-init conv / projection of a random UNet (uniform,
    1/sqrt(fan-in)): with them zero its output, and its gradient, are
    exactly 0 whatever the kernels compute."""
    import torch

    from cgd_tpu_torch.models.unet import Conv, Dense

    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, (Conv, Dense)) and m.zero:
                bound = 1.0 / float(torch.tensor(m.kernel.shape[:-1]).prod()) ** 0.5
                m.kernel.uniform_(-bound, bound, generator=gen)


class _FirstStep:
    """Patches the API for a guided run whose first step can be held to the
    plain routing's: the random UNet's zero-init layers re-drawn from a
    fixed seed (as phases 4 and 9c; else its output and gradient are 0 and
    no kernel reaches the sample), and ``x`` records each run's x after its
    first yielded step. With ``stop``, the run is interrupted after that step
    (the generator keeps its frame and ends)."""

    def __init__(self, api, dev, stop: bool = False):
        import torch

        self.api, self.x, self.stop = api, [], stop
        self.real = api.resolve_unet, api.sample_loop

        def resolve_redrawn(*a, **kw):
            unet, *rest = self.real[0](*a, **kw)
            _redraw_zero_init(unet, torch.Generator(dev).manual_seed(9))
            return (unet, *rest)

        def spy(*a, **kw):
            first = True
            for item in self.real[1](*a, **kw):
                if first:
                    self.x.append(item[2].detach().float().clone())
                yield item
                if first and self.stop:
                    raise KeyboardInterrupt
                first = False

        api.resolve_unet, api.sample_loop = resolve_redrawn, spy

    def close(self):
        self.api.resolve_unet, self.api.sample_loop = self.real

    def rel(self, phase: str) -> float:
        """The kernels' first x (the last run) against the plain routing's
        (the one before), relative L2, held to BF16_STEP_TOL."""
        plain, kern = self.x[-2], self.x[-1]
        rel = ((kern - plain).norm() / plain.norm()).item()
        if not rel <= BF16_STEP_TOL:
            raise AssertionError(f"{phase}: first bf16 step x, kernels vs plain: rel L2 "
                                 f"{rel:.3e} > {BF16_STEP_TOL}")
        return rel


def _full_unet(dev, size: int, dtype=None):
    """The full-width class-conditional UNet at ``size`` px, random conv
    weights in ``dtype`` (bf16 by default) with every zero-init conv
    re-drawn, and a probe input: (unet, n_params, run) where
    run(split=None) -> (output, input gradient), the UNet at compute dtype
    ``dtype``."""
    import torch

    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.ops.nn import cast_conv_params
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    cfg = UNetConfig.from_flags(DIFFUSION_LOOKUP["cond"][size]["model_flags"])
    gen = torch.Generator(dev).manual_seed(7)
    unet = UNet(cfg, device=dev).init_weights(gen)
    _redraw_zero_init(unet, gen)
    dtype = dtype or torch.bfloat16
    if dtype == torch.bfloat16:
        cast_conv_params(unet, dtype)
    n_params = sum(p.numel() for p in unet.parameters())
    x = torch.randn(1, size, size, 3, generator=gen, device=dev)
    t = torch.tensor([500.0], device=dev)
    y = torch.tensor([3], device=dev)
    probe = torch.randn(1, size, size, 6, generator=gen, device=dev)

    def run(split=None):
        """Output and input gradient; ``split(x)`` -> a Split input."""
        x_ = x.clone().requires_grad_(True)
        out = unet(x_ if split is None else split(x_), t, y, compute_dtype=dtype)
        out = out if split is None else out.gather()
        (g,) = torch.autograd.grad((out * probe).sum(), x_)
        return out.detach(), g

    return unet, n_params, run


def phase_unet(dev, size: int, tag: str = "4"):
    """Phase 4 (12a at 64px): full-width UNet at ``size`` px, kernels vs plain routing."""
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
        print(f"[{tag}] UNet {size}px ({n_params / 1e6:.1f}M params) {name}: rel L2 err {rel:.3e} "
              f"(max|ref| {b.abs().max().item():.3e})")
        if rel > UNET_TOL:
            raise AssertionError(f"UNet {size}px {name}: rel L2 {rel:.3e} > {UNET_TOL}")
    print(f"[{tag}] UNet {size}px fwd + input grad: kernels {ms_k:.2f} ms, plain routing "
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
    s per step, peak device memory of the kernels' run)."""
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
        return (stamps[-1] - stamps[0]) / max(steps, 1), stamps[-1] - t0, paths

    api.log_image = capture
    first = _FirstStep(api, dev)
    try:
        if mesh is not None:
            with kernel_routing("plain"):  # the first step on the same mesh
                timed(12, out_dir / "plain", n_frames=1)
            frames.clear()
            _reset_launches(k3, kattn)
            torch.cuda.reset_peak_memory_stats(dev)
            step_s, total_s, paths = timed(12, out_dir)
            launches = _launches(k3, kattn)
            peak = torch.cuda.max_memory_allocated(dev)
        else:
            # the host-bound step varies from run to run: time the plain
            # routing before and after the kernels' run, in one process
            with kernel_routing("plain"):
                plain_before, _, _ = timed(12, out_dir / "plain", n_frames=2)
            frames.clear()
            _reset_launches(k3, kattn)
            torch.cuda.reset_peak_memory_stats(dev)
            step_s, total_s, paths = timed(12, out_dir)  # frames at steps 0, 12, 24
            launches = _launches(k3, kattn)
            peak = torch.cuda.max_memory_allocated(dev)
            by_d = {d: dict(n) for d, n in kattn.LAUNCHES_BY_D.items()}
            with kernel_routing("plain"):
                plain_after, _, _ = timed(12, out_dir / "plain", n_frames=2)
            first.x.pop()  # plain_after's
        final = frames[len(paths) - 1]
    finally:
        api.log_image = real_log_image
        first.close()
    rel = first.rel("phase 7c" if mesh is not None else f"phase 5 {size}px")

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
        print(f"[7c] 256px ddim25 guided sampling on {mesh} (zero-init layers re-drawn): "
              f"first step's x vs the plain routing rel L2 {rel:.3e} (bound {BF16_STEP_TOL}); "
              f"{step_s * 1e3:.1f} ms per guided "
              f"step (phase 5, unsplit: {unsplit_step_s * 1e3:.1f} ms), {total_s:.2f} s per "
              f"image incl. model setup; launches {launches}; final frame |x|max "
              f"{np.abs(final).max():.3f}")
        return launches, step_s, peak
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 5")
    # every head dim of the model on the Hopper bodies: d = 64 at 256px;
    # 128 / 192 / 256 at 128px (the 32^2 / 16^2 / 8^2 levels)
    for d in ((128, 192, 256) if size == 128 else (64,)):
        if kattn.attn_plan(1, 4, 64, d)["body"] != "wgmma":
            raise AssertionError(f"phase 5 {size}px: attention at d = {d} is not on the Hopper body")
        _check_launched(by_d[d], ("attn_fwd", "attn_bwd"), f"phase 5 {size}px, d = {d}")
    print(f"[5] {size}px ddim25 guided sampling (zero-init layers re-drawn): first step's x "
          f"vs the plain routing rel L2 {rel:.3e} (bound {BF16_STEP_TOL}); "
          f"{step_s * 1e3:.1f} ms per guided step "
          f"(plain routing {plain_before * 1e3:.1f} ms before, {plain_after * 1e3:.1f} ms "
          f"after), {total_s:.2f} s per image incl. model setup; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}, "
          f"attention by head dim {({d: n for d, n in by_d.items() if any(n.values())})}; "
          f"final frame |x|max {np.abs(final).max():.3f}")
    return launches, step_s, peak


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

    first = _FirstStep(api, dev)
    try:
        plain_before = plain_step_s()
        first.x.clear()
        first.stop = True
        with kernel_routing("plain"):  # the CLI's first step, interrupted after it
            cli.main([*argv[:-2], str(out_dir / "plain_cli"), "-q"])
        first.stop = False
        api.log_image = capture
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        cli.main(argv)
        total_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        api.log_image = real_log_image
        first.close()
    rel = first.rel("phase 6")
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
    print(f"[6] CLI 512px RN50x16 ddim25 guided sampling (zero-init layers re-drawn): first "
          f"step's x vs the plain routing's CLI rel L2 {rel:.3e} (bound {BF16_STEP_TOL}); "
          f"{step_s * 1e3:.1f} ms per guided step "
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
        cdms = _device_ms(lambda: F.conv2d(stacked, w_oihw, padding=(0, 1)),
                          label=f"cuDNN halo {name}")
        out = k3.conv3x3_fwd(x, w, bias, A, B, skip, etop=etop, ebot=ebot)
        dms = _device_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip, etop=etop, ebot=ebot),
                         label=f"K-halo {name}")
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
              f"{cms:.4f} ms ({ms / cms:.2f}x), device {cdms:.4f} ms ({dms / cdms:.2f}x)"
              f"{_fmt(bound, dms)}")
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
    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    ckpts = out_dir / "checkpoints"
    shutil.rmtree(out_dir, ignore_errors=True)
    (ckpts / "clip").mkdir(parents=True)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(8)
    info = DIFFUSION_LOOKUP["cond"][256]
    unet = UNet(UNetConfig.from_flags(info["model_flags"]), device="cpu").init_weights(gen)
    _redraw_zero_init(unet, gen)
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


# ---------------------------------------------------------------------------
# phase 9: compute_dtype="float32" on the card
# ---------------------------------------------------------------------------

def _say9(msg: str) -> None:
    """A phase-9 line, with the card and its power limit."""
    print(f"[9] ({CARD}) {msg}")


def _fwd_f64(k3, x, w, bias, A=None, B=None, skip=None, up=False):
    """K-fwd's function evaluated in f64 (the plain versions compute in f32)."""
    import torch

    h = x.double()
    if A is not None:
        pre = h * A.double()[:, None, None, :] + B.double()[:, None, None, :]
        h = pre * torch.sigmoid(pre)
    h = k3._up2(h) if up else h
    out = k3._conv_nhwc(h, w.double()) + bias.double()
    return out if skip is None else out + skip.double()


def _dx_f64(k3, g, wt, x, A, B):
    """K-dx's function in f64: (dx, dA, dB)."""
    import torch

    acc = k3._conv_nhwc(g.double(), wt.double())
    pre = x.double() * A.double()[:, None, None, :] + B.double()[:, None, None, :]
    sig = torch.sigmoid(pre)
    dpre = acc * (sig * (1.0 + pre * (1.0 - sig)))
    return dpre * A.double()[:, None, None, :], (dpre * x.double()).sum((1, 2)), dpre.sum((1, 2))


def _attn_f64(q, k, v, g):
    """The attention and its backward in f64 on [N, T, d]: (out, dq, dk, dv)."""
    q, k, v, g = (z.double() for z in (q, k, v, g))
    s2 = q.shape[-1] ** -0.5
    p = ((q @ k.transpose(-1, -2)) * s2).softmax(-1)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return p @ v, (ds @ k) * s2, (ds.transpose(-1, -2) @ q) * s2, p.transpose(-1, -2) @ g


def _row(res: dict, name: str, err: float, **numbers) -> None:
    """Record a kernel row's error (the largest so far) and, when given, its
    timed numbers (the JSON line's row)."""
    entry = res.setdefault(name, {"err": 0.0})
    entry["err"] = max(entry["err"], err)
    entry.update(numbers)


def _plan_str(plan: dict) -> str:
    """The f32 conv plan's geometry, for a phase 9 / 10 line."""
    return (f"plan bn {plan['bn']} patch {plan['patch'][0]}x{plan['patch'][1]} k8 steps "
            f"{plan['k8_steps']} chunks {plan['chunks']} ksplit {plan['ksplit']} tiles "
            f"{plan['tiles']} on {plan['blocks']} blocks stages {plan['win_stages']}/"
            f"{plan['slab_stages']} smem {plan['smem_bytes']}"
            f"{' ' + '+'.join(sorted(plan['classes'])) if plan['classes'] else ''}")


def phase_f32_kernels(k3, kattn, dev) -> dict:
    """Phase 9a: K-fwd f32 in its prologue, residual and up modes, K-dx f32
    (both classes) and K-attn-f / K-attn-b f32 against their plain versions
    in f32 (bound F32_TOL of the reference's max) at the bf16 rows' shapes,
    each also against an f64 evaluation beside the plain version's own
    error; K-dx f32's dA/dB and K-attn-b f32 bit-identical over two runs.
    Timed: CUDA events, device time (torch.profiler), the plain version,
    and the library call (cuDNN f32 with TF32 off on the conv's actual
    input; SDPA at f32, its backend named). Bound: FLOPs / 495 TFLOP/s
    (TF32) or bytes / 3.35 TB/s."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(dev).manual_seed(909)

    def kernel_ms(fn, key, label):
        """CUDA-event ms, device ms (checked, ``_checked``; fresh: conv_bench's
        row ``key``) and the kernels per call the profiler counted."""
        dms, per_call, mark = _checked(fn, _conv_fresh(key), label)
        return _time_ms(fn), dms, f"{per_call:g} kernels/call{', ' + mark if mark else ''}"

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    res = {}
    # (name, out H = W, cin, cout, prologue, skip, up); for up, H is the output
    convs = [("conv3x3", 256, 3, 256, False, False, False, "fwd-256-3-256"),
             ("conv3x3_gn_silu_add", 256, 256, 256, True, True, False, "fwd-256-256-256-pro-res"),
             ("conv3x3_gn_silu_up", 128, 512, 512, True, False, True, "fwd-128-512-512-pro-up"),
             ("conv3x3_gn_silu", 16, 2048, 1024, True, False, False, "fwd-16-2048-1024-pro"),
             ("conv3x3_gn_silu", 256, 256, 6, True, False, False, "fwd-256-256-6-pro")]
    for name, ho, ci, co, pro, sk, up, key in convs:
        hs = ho // 2 if up else ho
        x, w, bias = rn(1, hs, hs, ci), rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
        A = 1.0 + 0.2 * rn(1, ci) if pro else None
        B = 0.2 * rn(1, ci) if pro else None
        skip = rn(1, ho, ho, co) if sk else None
        args = (x, w, bias, A, B, skip, up)
        out, ref = k3.conv3x3_fwd(*args), k3.conv3x3_fwd_plain(*args)
        if not torch.equal(out, k3.conv3x3_fwd(*args)):
            raise AssertionError(f"K-fwd f32 {name} {ho}^2 {ci}->{co}: repeated runs differ")
        err, rel = _rel_max(out, ref)
        exact = _fwd_f64(k3, *args)
        f64 = (_rel_max(out.double(), exact)[1], _rel_max(ref.double(), exact)[1])
        if rel > F32_TOL:
            raise AssertionError(f"K-fwd f32 {name} {ho}^2 {ci}->{co}: {rel:.3e} > {F32_TOL}")
        h = x if A is None else k3._silu_chain(x, A, B)[2]
        h = k3._up2(h) if up else h
        plan = k3.f32_plan(1, hs, hs, ci, co, up=up, sms=k3._sms(dev))
        ms, dms, kpc = kernel_ms(lambda: k3.conv3x3_fwd(*args), key, f"K-fwd f32 {key}")
        pms = _time_ms(lambda: k3.conv3x3_fwd_plain(*args))
        cms = _time_ms(lambda: k3._conv_nhwc(h, w))
        cdms = _device_ms(lambda: k3._conv_nhwc(h, w), _conv_fresh(key, "cudnn"), f"cuDNN {key}")
        flops = 2 * ho * ho * 9 * ci * co
        bd = _bound(flops, _nbytes(x, w, bias, A, B, skip, out), PEAK_TF32_FLOPS)
        _say9(f"K-fwd f32 {name:20s} {ho}^2 {ci}->{co}: max|err| {err:.3e} ({rel:.2e} of scale; "
              f"against f64 kernel {f64[0]:.2e}, plain f32 {f64[1]:.2e}) kernel {ms:.4f} ms, "
              f"device {dms:.4f} ms ({kpc}, {_tflops(flops, dms)}) plain {pms:.4f} ms; cuDNN f32 "
              f"{cms:.4f} ms, device {cdms:.4f} ms ({dms / cdms:.2f}x){_fmt(bd, dms)}; "
              f"{_plan_str(plan)}; bit-identical reruns")
        _row(res, "conv3x3_fwd_f32", err)
    # K-dx f32: (H = W, forward Cin -> Cout); 512^2 is the W >= 512 class
    for ho, ci, co in ((256, 256, 256), (16, 2048, 1024), (256, 256, 6), (512, 256, 128)):
        key = f"dx-{ho}-{ci}-{co}"
        x, g = rn(1, ho, ho, ci), rn(1, ho, ho, co)
        wt = k3._flip_t(rn(3, 3, ci, co, scale=(9 * ci) ** -0.5))
        A, B = 1.0 + 0.2 * rn(1, ci), 0.2 * rn(1, ci)
        args = (g, wt, x, A, B)
        got, again = k3.conv3x3_dx(*args), k3.conv3x3_dx(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K-dx f32 {ho}^2 {ci}->{co}: repeated runs differ")
        want, exact = k3.conv3x3_dx_plain(*args), _dx_f64(k3, *args)
        line = []
        for part, a, b, e in zip(("dx", "dA", "dB"), got, want, exact):
            err, rel = _rel_max(a, b)
            f64 = (_rel_max(a.double(), e)[1], _rel_max(b.double(), e)[1])
            line.append(f"{part} {err:.3e} ({rel:.2e}; f64: kernel {f64[0]:.2e}, plain "
                        f"{f64[1]:.2e})")
            if rel > F32_TOL:
                raise AssertionError(f"K-dx f32 {ho}^2 {ci}->{co} {part}: {rel:.3e} > {F32_TOL}")
            _row(res, "conv3x3_dx_f32", err)
        ms, dms, kpc = kernel_ms(lambda: k3.conv3x3_dx(*args), key, f"K-dx f32 {key}")
        pms = _time_ms(lambda: k3.conv3x3_dx_plain(*args))
        cms = _time_ms(lambda: k3._conv_nhwc(g, wt))
        cdms = _device_ms(lambda: k3._conv_nhwc(g, wt), _conv_fresh(key, "cudnn"), f"cuDNN {key}")
        plan = k3.f32_plan(1, ho, ho, co, ci, dx=True, sms=k3._sms(dev))
        flops = 2 * ho * ho * 9 * ci * co
        bd = _bound(flops, _nbytes(g, wt, x, A, B, *got), PEAK_TF32_FLOPS)
        _say9(f"K-dx f32 {ho}^2 {ci}->{co}{' (W >= 512 class)' if ho >= 512 else ''}: "
              f"{', '.join(line)} kernel {ms:.4f} ms, device {dms:.4f} ms ({kpc}, "
              f"{_tflops(flops, dms)}) "
              f"plain {pms:.4f} ms; cuDNN f32 conv alone {cms:.4f} ms, device {cdms:.4f} ms "
              f"({dms / cdms:.2f}x); bit-identical reruns{_fmt(bd, dms)}; {_plan_str(plan)}")
        if (ho, ci, co) == (256, 256, 256):
            _row(res, "conv3x3_dx_f32", 0.0, ms=ms, device_ms=dms, plain_ms=pms, library_ms=cms,
                 **bd)

    # attention: (batch, N heads, T, d): the six shapes the main paths launch
    # (the 64-512px UNets' d = 64 levels at 32^2, 16^2 and 8^2, the 128px
    # model's d = 128, 192 and 256), timed; then ragged T and batch 2, untimed
    for bt, n, t, d in ((1, 8, 1024, 64), (1, 16, 256, 64), (1, 16, 64, 64), (1, 4, 1024, 128),
                        (1, 4, 256, 192), (1, 4, 64, 256), (2, 2, 300, 192), (2, 3, 77, 64)):
        qkv, g = rn(bt, t, 3 * n * d), rn(bt, t, n * d)
        q, k, v = kattn.split_heads(qkv, n)
        gh = kattn.to_heads(g, n)
        out, lse = kattn.attention_fwd(qkv, n)
        ref = kattn.attention_fwd_plain(q, k, v)
        exact = _attn_f64(q, k, v, gh)
        err, rel = _rel_max(out, kattn.merge_heads(ref, bt))
        f64 = (_rel_max(out.double(), kattn.merge_heads(exact[0], bt))[1],
               _rel_max(ref.double(), exact[0])[1])
        label = f"B{bt} N{n} T{t} d{d}"
        if rel > F32_TOL:
            raise AssertionError(f"K-attn-f f32 {label}: {rel:.3e} > {F32_TOL}")
        _row(res, "attn_fwd_f32", err)
        dqkv = kattn.attention_bwd(qkv, out, lse, g, n)
        if not torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, n)):
            raise AssertionError(f"K-attn-b f32 {label}: repeated runs differ")
        line = []
        for part, a, b, e in zip(("dq", "dk", "dv"), dqkv.chunk(3, dim=-1),
                                 kattn.attention_bwd_plain(q, k, v, gh), exact[1:]):
            b, e = kattn.merge_heads(b, bt), kattn.merge_heads(e, bt)
            berr, brel = _rel_max(a, b)
            bf64 = (_rel_max(a.double(), e)[1], _rel_max(b.double(), e)[1])
            line.append(f"{part} {berr:.3e} ({brel:.2e}; f64: kernel {bf64[0]:.2e}, plain "
                        f"{bf64[1]:.2e})")
            if brel > F32_TOL:
                raise AssertionError(f"K-attn-b f32 {label} {part}: {brel:.3e} > {F32_TOL}")
            _row(res, "attn_bwd_f32", berr)
        head = (f"K-attn f32 {label}: fwd max|err| {err:.3e} ({rel:.2e}; f64: kernel "
                f"{f64[0]:.2e}, plain {f64[1]:.2e}), {', '.join(line)} (bit-identical reruns)")
        if bt > 1:
            _say9(head)
            continue
        q4, k4, v4, g4 = (z[None].contiguous() for z in (q, k, v, gh))
        sq, sk, sv = (z.detach().requires_grad_(True) for z in (q4, k4, v4))
        so = F.scaled_dot_product_attention(sq, sk, sv)
        fns = {"fwd": lambda: kattn.attention_fwd(qkv, n),
               "bwd": lambda: kattn.attention_bwd(qkv, out, lse, g, n),
               "sdpa_fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4),
               "sdpa_bwd": lambda: torch.autograd.grad(so, (sq, sk, sv), g4, retain_graph=True),
               "plain_fwd": lambda: kattn.attention_fwd_plain(q, k, v),
               "plain_bwd": lambda: kattn.attention_bwd_plain(q, k, v, gh)}
        eager = {key: _time_ms(fn) for key, fn in fns.items()}
        bench = {"fwd": "K-attn-f", "bwd": "K-attn-b", "sdpa_fwd": "SDPA fwd",
                 "sdpa_bwd": "SDPA bwd"}
        counted = {key: _checked(fns[key], _attn_fresh(n, t, d, call, "float32"),
                                 f"{call} f32 {label}")[:2] for key, call in bench.items()}
        dev_ms = {key: ms for key, (ms, _) in counted.items()}
        plan = kattn.f32_attn_plan(bt, n, t, d)
        _say9(f"{head}; {plan['body']} body, grid {plan['grid']['fwd']}, streamed tiles "
              f"{tuple(plan['stream'].values())}, stages {tuple(plan['stages'].values())}; "
              f"SDPA f32 backend {_sdpa_backend(q4, k4, v4)}")
        flops = {"fwd": 4 * n * t * t * d, "bwd": 10 * n * t * t * d}
        for key in ("fwd", "bwd"):
            tensors = (qkv, out, lse) if key == "fwd" else (qkv, out, lse, g, dqkv)
            bd = _bound(flops[key], _nbytes(*tensors), PEAK_TF32_FLOPS)
            _say9(f"  {label} {key}: kernel {eager[key]:.4f} ms, device {dev_ms[key]:.4f} ms "
                  f"({counted[key][1]:g} kernels/call, {_tflops(flops[key], dev_ms[key])}) plain "
                  f"{eager['plain_' + key]:.4f} ms; "
                  f"SDPA f32 {eager['sdpa_' + key]:.4f} ms, device {dev_ms['sdpa_' + key]:.4f} ms "
                  f"({dev_ms[key] / dev_ms['sdpa_' + key]:.2f}x){_fmt(bd, dev_ms[key])}")
            if (n, t, d) == (8, 1024, 64):
                _row(res, f"attn_{key}_f32", 0.0, ms=eager[key], device_ms=dev_ms[key],
                     plain_ms=eager["plain_" + key], library_ms=eager["sdpa_" + key], **bd)
    torch.cuda.synchronize()
    return res


def phase_f32_unets(k3, kattn, dev, sizes=(256, 128, 512), say=None) -> dict:
    """Phase 9b: the full 256px, 128px and 512px UNets at compute_dtype
    float32 (every zero-init conv re-drawn), kernels against
    kernel_routing("plain"), forward and input gradient (relative L2 <=
    F32_UNET_TOL); the 128px one must run the f32 attention at d = 128, 192
    and 256, the 512px one K-dx f32's W >= 512 class. Returns that class's
    launches in the 512px UNet's forward and input gradient. Phase 12a runs
    it at ``sizes`` (64,) with its own ``say``."""
    import torch

    from cgd_tpu_torch.ops.nn import kernel_routing

    say = say or _say9
    wide = {"launches": 0}
    real_dx = k3._conv3x3_dx_f32

    def count_wide(g, *a):  # K-dx f32 launches at images W >= 512
        wide["launches"] += g.shape[2] >= 512
        return real_dx(g, *a)

    for size in sizes:
        unet, n_params, run = _full_unet(dev, size, torch.float32)
        kattn.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        k3._conv3x3_dx_f32 = count_wide
        try:
            got = run()
        finally:
            k3._conv3x3_dx_f32 = real_dx
        peak = torch.cuda.max_memory_allocated(dev)
        by_d = {d: c["attn_fwd_f32"] + c["attn_bwd_f32"] for d, c in kattn.LAUNCHES_BY_D.items()}
        with kernel_routing("plain"):
            want = run()
        ms_k = _time_ms(run, iters=3)
        with kernel_routing("plain"):
            ms_p = _time_ms(run, iters=3)
        for name, a, b in zip(("output", "d/dx"), got, want):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"f32 UNet {size}px {name}: non-finite values")
            rel = ((a - b).norm() / b.norm()).item()
            say(f"UNet {size}px f32 ({n_params / 1e6:.1f}M params) {name}: rel L2 err "
                  f"{rel:.3e} (max|ref| {b.abs().max().item():.3e})")
            if rel > F32_UNET_TOL:
                raise AssertionError(f"f32 UNet {size}px {name}: rel L2 {rel:.3e} > {F32_UNET_TOL}")
        want_d = (128, 192, 256) if size == 128 else (64,)
        if any(by_d[d] == 0 for d in want_d):
            raise AssertionError(f"f32 UNet {size}px: f32 attention launches by d {by_d}")
        if size == 512 and wide["launches"] == 0:
            raise AssertionError("f32 UNet 512px: K-dx f32's W >= 512 class was not launched")
        wide_line = f"; K-dx f32 at W >= 512: {wide['launches']} launches" if size == 512 else ""
        say(f"UNet {size}px f32 fwd + input grad: kernels {ms_k:.2f} ms, plain routing "
              f"{ms_p:.2f} ms; peak memory {peak / 2**30:.2f} GiB; f32 attention launches by "
              f"head dim {({d: c for d, c in by_d.items() if c})}{wide_line}")
        del unet
        torch.cuda.empty_cache()
    return wide


def phase_f32_e2e(k3, kattn, dev, out_dir: Path, bf16_step_s: float, mesh=None,
                  f32_step_s: float = None, say=None) -> tuple:
    """Phase 9c: the 256px ViT-B/32 ddim25 guided run through
    ``api.clip_guided_diffusion(compute_dtype="float32")``, 16 cutouts:
    the random UNet's zero-init layers re-drawn (as phase 4; else its
    output and gradient are 0 and no kernel reaches the sample), the first
    guided step's x against the plain routing's from the same seed
    (relative L2 <= F32_STEP_TOL), finite frames, PNGs, peak device memory,
    ms per guided step beside phase 5's bf16 step; counters reset just
    before the run and read just after: every f32 kernel launched, no bf16
    kernel. Phase 10c with ``mesh`` (the plain routing on the same mesh):
    K-halo f32 and the f32 attention launched, no bf16 kernel and no
    unsplit K-fwd f32 / K-dx f32, the step beside phase 9c's unsplit f32
    step (``f32_step_s``) and phase 7c's bf16 mesh step (``bf16_step_s``).
    Returns (launch counts, s per guided step)."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.ops.nn import kernel_routing

    real_resolve = api.resolve_unet

    def resolve_redrawn(*a, **kw):
        unet, *rest = real_resolve(*a, **kw)
        _redraw_zero_init(unet, torch.Generator(dev).manual_seed(9))
        return (unet, *rest)

    say = say or _say9
    kwargs = dict(prompts=PROMPTS, image_size=256, num_cutouts=16, clip_model_name="ViT-B/32",
                  timestep_respacing="ddim25", weights_mode="random", seed=0, device=str(dev),
                  progress=False, compute_dtype="float32", save_frequency=12, mesh=mesh)
    first_x, frames, stamps, paths = [], [], [], []
    real_loop, real_log_image = api.sample_loop, api.log_image

    def spy(*a, **kw):  # the x after each yielded step (the first: step 0)
        for item in real_loop(*a, **kw):
            first_x.append(item[2].detach().clone())
            yield item

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    api.sample_loop, api.log_image, api.resolve_unet = spy, capture, resolve_redrawn
    try:
        with kernel_routing("plain"):
            for _ in api.clip_guided_diffusion(prefix_path=out_dir / "plain", **kwargs):
                break
        x_plain = first_x[0]
        first_x.clear()
        frames.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        for _, path in api.clip_guided_diffusion(prefix_path=out_dir, **kwargs):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            paths.append(path)
        launches = _launches(k3, kattn)
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        api.sample_loop, api.log_image, api.resolve_unet = real_loop, real_log_image, real_resolve
    rel = ((first_x[0] - x_plain).norm() / x_plain.norm()).item()
    phase = "phase 9c" if mesh is None else "phase 10c"
    if len(paths) != 3 or len(frames) != 3:
        raise AssertionError(f"{phase}: expected frames at steps 0, 12, 24; got {paths}")
    if frames[-1].shape != (256, 256, 3) or not all(np.isfinite(f).all() for f in frames):
        raise AssertionError(f"{phase}: non-finite frames or a wrong shape")
    _check_pngs((*paths, "current.png"))
    if rel > F32_STEP_TOL:
        raise AssertionError(f"{phase}: first f32 step x, kernels vs plain: rel L2 {rel:.3e} > "
                             f"{F32_STEP_TOL}")
    convs = ("conv3x3_fwd_f32", "conv3x3_dx_f32") if mesh is None else ("conv3x3_fwd_halo_f32",)
    _check_launched(launches, (*convs, "attn_fwd_f32", "attn_bwd_f32"), phase)
    bf16 = {k: launches[k] for k in ("conv3x3_fwd", "conv3x3_fwd_halo", "conv3x3_dx",
                                     "conv3x3_dx_wtiled", "attn_fwd", "attn_bwd")}
    if any(bf16.values()):
        raise AssertionError(f"{phase}: the f32 run launched bf16 kernels {bf16}")
    if mesh is not None:
        unsplit = {k: launches[k] for k in ("conv3x3_fwd_f32", "conv3x3_dx_f32")}
        if any(unsplit.values()):
            raise AssertionError(f"phase 10c: the split UNet launched unsplit convs {unsplit}")
    step_s = (stamps[-1] - stamps[0]) / 24
    per_step = {k: v / 25 for k, v in launches.items() if v}
    beside = (f"phase 5, bf16: {bf16_step_s * 1e3:.1f} ms" if mesh is None else
              f"phase 9c, unsplit f32: {f32_step_s * 1e3:.1f} ms; phase 7c, bf16 on the mesh: "
              f"{bf16_step_s * 1e3:.1f} ms")
    say(f"256px ViT-B/32 ddim25 guided sampling at compute_dtype float32"
        f"{'' if mesh is None else f' on {mesh}'}: first step's x vs the plain routing rel L2 "
        f"{rel:.3e}; {step_s * 1e3:.1f} ms per guided step ({beside}), {total_s:.2f} s per "
        f"image incl. model setup; peak device memory {peak / 2**30:.2f} GiB; launches per "
        f"step {per_step}; bf16 kernels {bf16}; final frame |x|max "
        f"{np.abs(frames[-1]).max():.3f}")
    return launches, step_s


# ---------------------------------------------------------------------------
# phase 10: the height-split mesh at compute_dtype="float32" (K-halo f32)
# ---------------------------------------------------------------------------

def _say10(msg: str) -> None:
    """A phase-10 line, with the card and its power limit."""
    print(f"[10] ({CARD}) {msg}")


def phase_halo_f32(k3, dev) -> dict:
    """Phase 10a: K-halo f32 through kernels.conv_spmd on two shards of one
    card, forward and input gradient, against the plain version with
    autograd (bound F32_TOL of the reference's max) and against f64 (the
    unsplit conv of the stacked shards, which the halo exchange reproduces
    exactly) beside the plain version's own error, at phase 7a's shard
    shapes and the 8^2 level's 4-row (cut=2) and 2-row (cut=4) shards. One
    shard's launch timed (CUDA events and device time) beside cuDNN f32
    (TF32 off) on the stacked rows, K-fwd f32 on the same shard and the
    plain version. Bound: FLOPs / 495 TFLOP/s (TF32) or bytes / 3.35 TB/s."""
    import torch
    import torch.nn.functional as F

    from cgd_tpu_torch.kernels import conv_spmd

    gen = torch.Generator(dev).manual_seed(1010)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    res = {"err": 0.0}
    for name, hs, wd, ci, co, pro, sk in HALO_F32_SHARDS:
        xs = [rn(1, hs, wd, ci) for _ in range(2)]
        w, bias = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
        A = 1.0 + 0.2 * rn(1, ci) if pro else None
        B = 0.2 * rn(1, ci) if pro else None
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

        got, want = [], []
        for fn, into in ((kernel, got), (plain, want)):
            k3.reset_launch_counts()
            xs_ = [x.clone().requires_grad_(True) for x in xs]
            outs = fn(xs_)
            dxs = torch.autograd.grad(outs, xs_, gs)
            into.extend((torch.cat(outs, 1).detach(), torch.cat(dxs, 1)))
            if fn is kernel and k3.LAUNCHES["conv3x3_fwd_halo_f32"] != 4:
                raise AssertionError(f"K-halo f32 {name}: launches {k3.LAUNCHES}, not 4 of "
                                     "conv3x3_fwd_halo_f32")
        x64 = torch.cat(xs, 1).double().requires_grad_(True)
        out64 = _fwd_f64(k3, x64, w, bias, A, B, None if skips is None else torch.cat(skips, 1))
        exact = (out64.detach(), torch.autograd.grad(out64, x64, torch.cat(gs, 1).double())[0])
        line = []
        for part, a, b, e in zip(("fwd", "dx"), got, want, exact):
            err, rel = _rel_max(a, b)
            f64 = (_rel_max(a.double(), e)[1], _rel_max(b.double(), e)[1])
            line.append(f"{part} {err:.3e} ({rel:.2e}; f64: kernel {f64[0]:.2e}, plain "
                        f"{f64[1]:.2e})")
            if rel > F32_TOL:
                raise AssertionError(f"K-halo f32 {name} {hs}x{wd} {ci}->{co} {part}: "
                                     f"{rel:.3e} > {F32_TOL}")
            res["err"] = max(res["err"], err)
        # one shard's launch (the lower one: etop from the upper, a zero ebot)
        x, skip = xs[1], None if skips is None else skips[1]
        act = x if A is None else conv_spmd._act_rows(x, A, B)
        etop = conv_spmd._act_rows(xs[0][:, -1:], A, B) if pro else xs[0][:, -1:].contiguous()
        ebot = torch.zeros_like(etop)

        def halo():
            return k3.conv3x3_fwd(x, w, bias, A, B, skip, etop=etop, ebot=ebot)

        stacked = torch.cat([etop, act, ebot], dim=1).permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1)

        def cudnn():
            return F.conv2d(stacked, w_oihw, padding=(0, 1))

        got1 = halo()
        if not torch.equal(got1, halo()):
            raise AssertionError(f"K-halo f32 {name} shard {hs}x{wd}: repeated runs differ")
        key = (f"halo-{hs}x{wd}-{ci}-{co}" + ("-gn" if pro else "") + ("-res" if sk else ""))
        ms = _time_ms(halo)
        dms, per_call, mark = _checked(halo, _conv_fresh(key), f"K-halo f32 {key}")
        fwd_ms = _time_ms(lambda: k3.conv3x3_fwd(x, w, bias, A, B, skip))
        pms = _time_ms(lambda: k3.conv3x3_fwd_halo_plain(x, w, bias, A, B, skip, etop, ebot))
        cms = _time_ms(cudnn)
        cdms = _device_ms(cudnn, _conv_fresh(key, "cudnn"), f"cuDNN {key}")
        plan = k3.f32_plan(1, hs, wd, ci, co, halo=True, sms=k3._sms(dev))
        flops = 2 * hs * wd * 9 * ci * co
        bound = _bound(flops, _nbytes(x, w, bias, A, B, skip, etop, ebot, halo()), PEAK_TF32_FLOPS)
        _say10(f"K-halo f32 {name:20s} shard {hs}x{wd} {ci}->{co}: {', '.join(line)}; kernel "
               f"{ms:.4f} ms, device {dms:.4f} ms ({per_call:g} kernels/call"
               f"{', ' + mark if mark else ''}, "
               f"{_tflops(flops, dms)}; K-fwd f32 on the shard {fwd_ms:.4f} ms) plain "
               f"{pms:.4f} ms; cuDNN f32 on the stacked rows {cms:.4f} ms, device {cdms:.4f} ms "
               f"({dms / cdms:.2f}x){_fmt(bound, dms)}; {_plan_str(plan)}; bit-identical reruns")
        if (hs, ci, co, sk) == (128, 256, 256, True):
            res.update(ms=ms, plain_ms=pms, library_ms=cms, **bound, device_ms=dms)
    torch.cuda.synchronize()
    return res


def phase_split_unet_f32(k3, dev) -> None:
    """Phase 10b: the full-width 256px UNet at compute_dtype float32 split
    cut=2 on one card against the unsplit f32 kernel UNet, forward and input
    gradient (relative L2 <= F32_UNET_TOL); the split run must launch K-halo
    f32 and no other conv kernel, and no bf16 kernel."""
    import torch

    from cgd_tpu_torch.parallel.mesh import make_mesh, split_activation

    unet, n_params, run = _full_unet(dev, 256, torch.float32)
    mesh = make_mesh([dev, dev])

    def split(x):
        return split_activation(x, mesh)

    out_u, g_u = run()
    k3.reset_launch_counts()
    out_s, g_s = run(split)
    launches = dict(k3.LAUNCHES)
    if launches["conv3x3_fwd_halo_f32"] == 0 or sum(launches.values()) != launches[
            "conv3x3_fwd_halo_f32"]:
        raise AssertionError(f"phase 10b: the split f32 UNet's conv launches {launches}")
    ms_u = _time_ms(run, iters=3)
    ms_s = _time_ms(lambda: run(split), iters=3)
    for name, a, b in (("output", out_s, out_u), ("d/dx", g_s, g_u)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"split f32 UNet {name}: non-finite values")
        rel = ((a - b).norm() / b.norm()).item()
        _say10(f"UNet 256px f32 ({n_params / 1e6:.1f}M params) split cut=2 vs unsplit, {name}: "
               f"rel L2 err {rel:.3e}")
        if rel > F32_UNET_TOL:
            raise AssertionError(f"split f32 UNet 256px {name}: rel L2 {rel:.3e} > "
                                 f"{F32_UNET_TOL}")
    _say10(f"UNet 256px f32 fwd + input grad: split cut=2 {ms_s:.2f} ms, unsplit {ms_u:.2f} ms; "
           f"conv launches of the split run {({k: v for k, v in launches.items() if v})}")
    del unet
    torch.cuda.empty_cache()


def phase_f32_mesh_cli(k3, kattn, dev, out_dir: Path) -> None:
    """Phase 10d: ``cgd_tpu_torch.cli.main`` with ``--mesh cut=2
    --compute-dtype float32`` (256px, ViT-B/32, 16 cutouts, ddim25, random
    weights). One card: the CLI builds its mesh over the visible cards, so
    ``visible_devices`` is patched to give the one card twice (what
    ``make_mesh([dev, dev])`` does for the API). Checks finite frames, the
    PNGs, K-halo f32 and the f32 attention launched, no bf16 kernel."""
    import numpy as np

    from cgd_tpu_torch import api, cli
    from cgd_tpu_torch.parallel import mesh as pmesh

    out_dir.mkdir(parents=True, exist_ok=True)
    argv = ["--prompts", "|".join(PROMPTS), "-size", "256", "-cutn", "16", "-respace", "ddim25",
            "--weights-mode", "random", "-freq", "12", "--mesh", "cut=2", "--compute-dtype",
            "float32", "-dir", str(out_dir), "-q"]
    frames = []
    real_log_image, real_visible = api.log_image, pmesh.visible_devices

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    api.log_image = capture
    pmesh.visible_devices = lambda kind="cuda": [dev, dev]
    try:
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        cli.main(argv)
        total_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
    finally:
        api.log_image, pmesh.visible_devices = real_log_image, real_visible
    pngs = sorted(out_dir.rglob("*.png"))
    if len(frames) != 3 or len(pngs) != 3:
        raise AssertionError(f"phase 10d: expected frames at steps 0, 12, 24; got {pngs}")
    if frames[-1].shape != (256, 256, 3) or not all(np.isfinite(f).all() for f in frames):
        raise AssertionError("phase 10d: non-finite frames or a wrong shape")
    _check_pngs(pngs)
    _check_launched(launches, ("conv3x3_fwd_halo_f32", "attn_fwd_f32", "attn_bwd_f32"),
                    "phase 10d")
    other = {k: v for k, v in launches.items() if v and k not in (
        "conv3x3_fwd_halo_f32", "attn_fwd_f32", "attn_bwd_f32")}
    if other:
        raise AssertionError(f"phase 10d: the split f32 CLI run launched {other}")
    _say10(f"CLI --mesh cut=2 --compute-dtype float32, 256px ddim25 (two copies of the one "
           f"card): {total_s:.2f} s per image incl. model setup; launches {launches}")


# ---------------------------------------------------------------------------
# phase 12: the 64px model and the sampler's options (augs, fast guidance,
# DPM-Solver++(2M), reduce_clip, progressive cutouts, offsets, noise_file)
# ---------------------------------------------------------------------------

def _say12(sub: str, msg: str) -> None:
    """A phase-12 line, with the card and its power limit."""
    print(f"[12{sub}] {msg} ({CARD})")


def _numpy_aug_draws(dev, calls: int = 25, n: int = 16, size: int = 224):
    """A draw_augs stand-in whose draws come from numpy, made up front (one
    set per call of a 25-step run, for n cutouts of size^2 x 3) and handed
    out in call order; ``reset`` starts a run again, so two runs see the
    same augmentations at the same steps."""
    import numpy as np
    import torch

    from cgd_tpu_torch.guidance.cutouts import AugDraws

    rs = np.random.RandomState(1000)
    lim = 0.4 / size
    sets = []
    for _ in range(calls):
        arrays = (rs.rand(n) < 0.5, rs.uniform(-15, 15, n), rs.uniform(-0.1, 0.1, n),
                  rs.uniform(-0.1, 0.1, n), rs.rand(n) < 0.7, rs.uniform(-lim, lim, (n, 2)),
                  rs.rand(n) < 0.15, rs.randn(n, size, size, 3))
        sets.append(AugDraws(*(torch.as_tensor(a if a.dtype == bool else a.astype(np.float32),
                                               device=dev) for a in arrays)))
    taken = [0]

    def draw(gen, n_, h, w, c):
        if (n_, h, w, c) != (n, size, size, 3):
            raise AssertionError(f"phase 12b: augmentations asked for {(n_, h, w, c)}")
        taken[0] += 1
        return sets[taken[0] - 1]

    draw.taken = taken
    draw.reset = lambda: taken.__setitem__(0, 0)
    return draw


def phase_64px_api(k3, kattn, dev, out_dir: Path) -> None:
    """Phase 12b: the 64px model through ``api.clip_guided_diffusion``, ViT-B/32,
    16 cutouts, ddim25, ``use_augs`` with numpy-drawn augmentations (the same
    in both runs), the zero-init layers re-drawn: the first guided step's x
    against the plain routing's (relative L2 <= BF16_STEP_TOL), the 64px
    magnitude line, finite 64 x 64 frames, PNGs, every kernel of the path
    launched (the attention at d = 64); the step time, s per image and the
    launches, the attention's by head dim."""
    import contextlib
    import io

    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.guidance import cutouts
    from cgd_tpu_torch.ops.nn import kernel_routing

    kwargs = dict(prompts=PROMPTS, image_size=64, num_cutouts=16, clip_model_name="ViT-B/32",
                  timestep_respacing="ddim25", weights_mode="random", seed=0, device=str(dev),
                  use_augs=True, save_frequency=12)
    draw = _numpy_aug_draws(dev)
    real_draw, real_log_image = cutouts.draw_augs, api.log_image
    frames, stamps, paths = [], [], []

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    cutouts.draw_augs = draw
    first = _FirstStep(api, dev)
    said = io.StringIO()
    try:
        with kernel_routing("plain"):
            for _ in api.clip_guided_diffusion(prefix_path=out_dir / "plain", progress=False,
                                               **kwargs):
                break
        draw.reset()
        api.log_image = capture
        _reset_launches(k3, kattn)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            for _, path in api.clip_guided_diffusion(prefix_path=out_dir, **kwargs):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                paths.append(path)
        total_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
        peak = torch.cuda.max_memory_allocated(dev)
        by_d = {d: dict(n) for d, n in kattn.LAUNCHES_BY_D.items() if any(n.values())}
    finally:
        cutouts.draw_augs, api.log_image = real_draw, real_log_image
        first.close()
    print(said.getvalue(), end="")
    rel = first.rel("phase 12b")
    if "Enabling magnitude for 64x64 checkpoints." not in said.getvalue():
        raise AssertionError("phase 12b: the 64px run did not turn the magnitude clamp on")
    if "Augmentations enabled." not in said.getvalue() or draw.taken[0] != 25:
        raise AssertionError(f"phase 12b: augmentations drawn {draw.taken[0]} times, not 25")
    if len(paths) != 3 or any(f.shape != (64, 64, 3) or not np.isfinite(f).all() for f in frames):
        raise AssertionError(f"phase 12b: frames {[f.shape for f in frames]}, paths {paths}")
    _check_pngs(paths)
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 12b")
    _check_launched(by_d.get(64, {"attn_fwd": 0}), ("attn_fwd", "attn_bwd"), "phase 12b, d = 64")
    step_s = (stamps[-1] - stamps[0]) / 24
    _say12("b", f"64px ViT-B/32 ddim25 guided sampling with augs (zero-init layers re-drawn): "
                f"first step's x vs the plain routing rel L2 {rel:.3e} (bound {BF16_STEP_TOL}); "
                f"{step_s * 1e3:.1f} ms per guided step, {total_s:.2f} s per image incl. model "
                f"setup; peak device memory {peak / 2**30:.2f} GiB; launches {launches} "
                f"({sum(launches.values()) / 25:.1f} per step), attention by head dim {by_d}")


def phase_fast_guidance(k3, kattn, dev, out_dir: Path, step_s: float, peak: float) -> None:
    """Phase 12c: the 256px ddim25 run of phase 5 with ``fast_guidance``:
    K-dx, K-dx-w and K-attn-b (bf16 and f32) launched no time, K-fwd and
    K-attn-f launched; the first step's x against the plain routing's fast
    step (relative L2 <= BF16_STEP_TOL); the step time and peak memory
    beside phase 5's guided step."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.ops.nn import kernel_routing

    kwargs = dict(prompts=PROMPTS, image_size=256, num_cutouts=16, clip_model_name="ViT-B/32",
                  timestep_respacing="ddim25", weights_mode="random", seed=0, device=str(dev),
                  progress=False, fast_guidance=True, save_frequency=12)
    frames, stamps = [], []
    real_log_image = api.log_image

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    first = _FirstStep(api, dev)
    try:
        with kernel_routing("plain"):
            for _ in api.clip_guided_diffusion(prefix_path=out_dir / "plain", **kwargs):
                break
        api.log_image = capture
        _reset_launches(k3, kattn)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in api.clip_guided_diffusion(prefix_path=out_dir, **kwargs):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        total_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
        fast_peak = torch.cuda.max_memory_allocated(dev)
    finally:
        api.log_image = real_log_image
        first.close()
    rel = first.rel("phase 12c")
    backward = {k: launches[k] for k in ("conv3x3_dx", "conv3x3_dx_wtiled", "attn_bwd",
                                         "conv3x3_dx_f32", "attn_bwd_f32")}
    if any(backward.values()):
        raise AssertionError(f"phase 12c: fast guidance launched backward kernels {backward}")
    _check_launched(launches, ("conv3x3_fwd", "attn_fwd"), "phase 12c")
    if len(frames) != 3 or not all(np.isfinite(f).all() for f in frames):
        raise AssertionError("phase 12c: non-finite frames or a wrong count")
    fast_s = (stamps[-1] - stamps[0]) / 24
    _say12("c", f"256px ViT-B/32 ddim25 with fast guidance: first step's x vs the plain "
                f"routing's fast step rel L2 {rel:.3e} (bound {BF16_STEP_TOL}); "
                f"{fast_s * 1e3:.1f} ms per guided step (phase 5, full guidance: "
                f"{step_s * 1e3:.1f} ms), {total_s:.2f} s per image incl. model setup; peak "
                f"device memory {fast_peak / 2**30:.2f} GiB (phase 5: {peak / 2**30:.2f} GiB); "
                f"backward launches {backward}; launches {launches}")


def phase_dpm(k3, kattn, dev, out_dir: Path) -> None:
    """Phase 12d: the 256px ddim25 run with ``dpm_solver``: finite frames,
    and its first (first-order) step equal to a DDIM eta = 0 step from the
    same x, model output and guidance gradient (relative L2 <= 1e-5)."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.diffusion.gaussian import GaussianDiffusion

    real = GaussianDiffusion.dpm_solver2m_step
    steps = []

    def spy(self, out, x, t, t_prev, first, x0_prev, cond_grad=None):
        x_next, x0 = real(self, out, x, t, t_prev, first, x0_prev, cond_grad)
        if not steps:
            ddim = self.ddim_sample_step(out, x, t, torch.zeros_like(x), cond_grad, eta=0.0)
            steps.append(((x_next - ddim).norm() / ddim.norm()).item())
        steps.append(bool(first))
        return x_next, x0

    frames = []
    real_log_image = api.log_image

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    GaussianDiffusion.dpm_solver2m_step, api.log_image = spy, capture
    try:
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        for _ in api.clip_guided_diffusion(
                prompts=PROMPTS, image_size=256, num_cutouts=16, timestep_respacing="ddim25",
                weights_mode="random", seed=0, device=str(dev), progress=False,
                dpm_solver=True, save_frequency=12, prefix_path=out_dir):
            pass
        total_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
    finally:
        GaussianDiffusion.dpm_solver2m_step, api.log_image = real, real_log_image
    rel, firsts = steps[0], steps[1:]
    if firsts != [True] + [False] * 24:
        raise AssertionError(f"phase 12d: first-order flags {firsts}")
    if not rel <= 1e-5:
        raise AssertionError(f"phase 12d: the first DPM step vs DDIM eta = 0: rel L2 {rel:.3e}")
    if len(frames) != 3 or not all(np.isfinite(f).all() for f in frames):
        raise AssertionError("phase 12d: non-finite frames or a wrong count")
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 12d")
    _say12("d", f"256px ddim25 with DPM-Solver++(2M): the first step vs a DDIM eta = 0 step "
                f"from the same state rel L2 {rel:.3e} (bound 1e-5); {total_s:.2f} s per image "
                f"incl. model setup; final frame |x|max {np.abs(frames[-1]).max():.3f}")


def phase_reduce_cli(k3, kattn, dev, out_dir: Path) -> None:
    """Phase 12e: the CLI at 128px with ``-reduce -cutn_skip -cached_cutn -ht
    0 -wd 64`` (a 128 x 192 sample), ddim25, the zero-init layers re-drawn:
    the first step's x against the plain routing's CLI run, interrupted
    after that step (relative L2 <= BF16_STEP_TOL); the frames' shape, the
    steps that ran guided (and their cutout counts) against the step plan,
    and a run that ends with every step done."""
    import numpy as np

    from cgd_tpu_torch import api, cli
    from cgd_tpu_torch.diffusion.sampler import build_step_plan
    from cgd_tpu_torch.ops.nn import kernel_routing

    guided, frames = [], []
    real_builder, real_log_image = api.make_guidance_builder, api.log_image

    def builder(*a, **kw):
        inner = real_builder(*a, **kw)

        def build(meta):
            fns = inner(meta)

            def loss_fn(x, out, ref_t, gen):
                guided.append((ref_t, meta.cutn, tuple(x.shape)))
                return fns.loss_fn(x, out, ref_t, gen)

            return fns._replace(loss_fn=loss_fn)

        return build

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real_log_image(image, *a, **kw)

    argv = ["--prompts", "|".join(PROMPTS), "-size", "128", "-cutn", "16", "-respace", "ddim25",
            "--weights-mode", "random", "-reduce", "-cutn_skip", "-cached_cutn", "-ht", "0",
            "-wd", "64", "-freq", "5", "-dir", str(out_dir), "-q"]
    out_dir.mkdir(parents=True, exist_ok=True)  # the CLI makes only its last level
    first = _FirstStep(api, dev, stop=True)
    try:
        with kernel_routing("plain"):  # the first step, interrupted after it
            cli.main([*argv[:-2], str(out_dir / "plain"), "-q"])
        first.stop = False
        api.make_guidance_builder, api.log_image = builder, capture
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        cli.main(argv)
        total_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
    finally:
        api.make_guidance_builder, api.log_image = real_builder, real_log_image
        first.close()
    rel = first.rel("phase 12e")
    if first.x[-1].shape != (1, 128, 192, 3):
        raise AssertionError(f"phase 12e: the first step's x is {tuple(first.x[-1].shape)}")
    plan = build_step_plan(25, 5, True, True, 16)
    want = [(24 - k, m.cutn) for k, m in enumerate(plan) if m.guided]
    if [(t, n) for t, n, _ in guided] != want:
        raise AssertionError(f"phase 12e: guided steps {guided} against the plan's {want}")
    if any(shape != (1, 128, 192, 3) for *_, shape in guided):
        raise AssertionError("phase 12e: a guided step's x is not 128 x 192")
    if len(frames) != 4 or any(f.shape != (128, 192, 3) or not np.isfinite(f).all()
                               for f in frames):
        raise AssertionError(f"phase 12e: frames {[f.shape for f in frames]}")
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 12e")
    _say12("e", f"CLI 128px -reduce -cutn_skip -cached_cutn -ht 0 -wd 64 ddim25 (128 x 192, "
                f"zero-init layers re-drawn): first step's x vs the plain routing's CLI rel L2 "
                f"{rel:.3e} (bound {BF16_STEP_TOL}); {len(plan)} steps after the 5 skipped, "
                f"{len(guided)} guided as the plan says (cutouts {[n for _, n in want]}); "
                f"{total_s:.2f} s per image incl. model setup; launches {launches}")


def phase_noise_file(dev, out_dir: Path) -> None:
    """Phase 12f: a 64px run's noise, sampled ancestrally over 5 steps so
    that the step noise reaches the frames (its starting noise and each
    step's, the draws of the sample's shape from the run's generator),
    recorded to an npz of the JAX package's layout, then replayed through
    ``noise_file``: the frames equal within 1e-6 relative. Two replays of
    altered noise (the steps reversed; the starting noise halved) must
    differ from the recorded frames by more than that: the replay's own
    generator draws the recorded noise anyway, so only they show that
    both parts of the file are read."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api

    kwargs = dict(prompts=PROMPTS, image_size=64, num_cutouts=16, timestep_respacing="5",
                  weights_mode="random", seed=3, device=str(dev), progress=False,
                  save_frequency=1)
    frames = []
    real_log_image, real_randn = api.log_image, torch.randn
    drawn = []

    def capture(image, *a, **kw):
        frames.append(np.asarray(image, np.float64))
        return real_log_image(image, *a, **kw)

    def recording(*a, **kw):
        out = real_randn(*a, **kw)
        if tuple(out.shape) == (1, 64, 64, 3) and kw.get("generator") is not None:
            drawn.append(out.cpu().numpy())
        return out

    def replay(tag, init, steps):
        np.savez(out_dir / f"{tag}.npz", init=init, steps=steps)
        frames.clear()
        list(api.clip_guided_diffusion(prefix_path=out_dir / tag,
                                       noise_file=str(out_dir / f"{tag}.npz"), **kwargs))
        return list(frames)

    def rel(a_frames, b_frames):
        return max(np.abs(a - b).max() / np.abs(a).max() for a, b in zip(a_frames, b_frames))

    api.log_image = capture
    try:
        torch.randn = recording
        try:
            list(api.clip_guided_diffusion(prefix_path=out_dir / "recorded", **kwargs))
        finally:
            torch.randn = real_randn
        recorded = list(frames)
        if len(drawn) != 6:
            raise AssertionError(f"phase 12f: {len(drawn)} noise draws, not 6")
        steps = np.stack(drawn[1:])
        replayed = replay("replayed", drawn[0], steps)
        reversed_steps = replay("steps_reversed", drawn[0], steps[::-1])
        halved_init = replay("init_halved", 0.5 * drawn[0], steps)
    finally:
        api.log_image = real_log_image
    if any(len(f) != 5 for f in (recorded, replayed, reversed_steps, halved_init)):
        raise AssertionError("phase 12f: a run did not write 5 frames")
    same = rel(recorded, replayed)
    if not same <= 1e-6:
        raise AssertionError(f"phase 12f: replayed frames differ: {same:.3e} relative")
    controls = {"steps reversed": rel(recorded, reversed_steps),
                "init halved": rel(recorded, halved_init)}
    if not all(c > 1e-6 for c in controls.values()):
        raise AssertionError(f"phase 12f: a replay of altered noise gave the recorded frames "
                             f"{controls}")
    _say12("f", f"64px 5-step ancestral noise recorded ({len(drawn)} draws) and replayed "
                f"through noise_file: frames equal within {same:.3e} relative (bound 1e-6); "
                f"altered replays differ by "
                f"{', '.join(f'{k} {v:.3e}' for k, v in controls.items())}")


def phase_12(k3, kattn, dev, step_s: float, peak: float) -> None:
    """Phase 12, in order: (a) the 64px kernels and UNets, (b) the 64px API
    run with augs, (c) fast guidance, (d) DPM-Solver++(2M), (e) the CLI with
    -reduce -cutn_skip and a width offset, (f) noise_file."""
    t0 = time.perf_counter()
    phase_kernels(k3, dev, CONV_CASES_64, tag="12a")
    phase_attention(kattn, dev, ATTN_CASES_64, tag="12a")
    phase_unet(dev, 64, tag="12a")
    phase_f32_unets(k3, kattn, dev, sizes=(64,), say=lambda msg: _say12("a", msg))
    out = ROOT / "outputs" / "chip_smoke_12"
    phase_64px_api(k3, kattn, dev, out / "64px")
    phase_fast_guidance(k3, kattn, dev, out / "fast", step_s, peak)
    phase_dpm(k3, kattn, dev, out / "dpm")
    phase_reduce_cli(k3, kattn, dev, out / "cli")
    phase_noise_file(dev, out / "noise")
    _say12("", f"phase 12 wall time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: resume, the serving daemon, the rest of the CLI
# ---------------------------------------------------------------------------

def _say13(sub: str, msg: str) -> None:
    """A phase-13 line, with the card and its power limit."""
    print(f"[13{sub}] {msg} ({CARD})")


class _Frames:
    """Patches ``api.log_image`` to keep every frame by output directory:
    ``by_dir[str(prefix_path)]`` lists the frames in the order written."""

    def __init__(self, api):
        import numpy as np

        self.api, self.real, self.by_dir = api, api.log_image, {}

        def capture(image, base_path, *a, **kw):
            self.by_dir.setdefault(str(base_path), []).append(np.asarray(image, np.float32))
            return self.real(image, base_path, *a, **kw)

        api.log_image = capture

    def close(self):
        self.api.log_image = self.real


def _diff(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _hold_resumed(phase: str, ab: float, ares: float, actrl: float) -> str:
    """The determinism rule: the resumed run equals the uninterrupted one
    bit for bit where two uninterrupted runs are bit-equal, and stays within
    their difference where they are not; the control (the generator state
    overwritten by a fresh ``manual_seed``) differs by more than that."""
    if ab == 0.0 and ares != 0.0:
        raise AssertionError(f"{phase}: two runs are bit-equal but the resumed run differs by "
                             f"{ares:.3e}")
    if ares > ab:
        raise AssertionError(f"{phase}: the resumed run differs by {ares:.3e}, more than two "
                             f"uninterrupted runs do ({ab:.3e})")
    if not actrl > ab:
        raise AssertionError(f"{phase}: the resume with a fresh generator state differs by "
                             f"{actrl:.3e}, not more than two runs do ({ab:.3e})")
    return "bit-equal" if ab == 0.0 else "within the runs' own difference"


def phase_resume(dev, out_dir: Path, size: int, sub: str, **options) -> bool:
    """Phases 13a (256px, bf16) and 13b (128px DPM-Solver++(2M)): ddim10,
    save_frequency 3, the zero-init layers re-drawn, through the API. Run A
    uninterrupted with ``checkpoint_path``; run B the same, closed after its
    second frame, then resumed from B's checkpoint to the end; run C a
    second uninterrupted run; and the control, B's checkpoint with its
    generator state overwritten by a fresh ``manual_seed(0)``. max |A - C|
    and max |A - resumed B| over the final frame and x are held to the
    determinism rule (``_hold_resumed``). Prints the checkpoint's size and
    the host ms per segment its write takes. Returns whether A and C were
    bit-equal."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api

    kwargs = dict(prompts=PROMPTS, image_size=size, num_cutouts=16, timestep_respacing="ddim10",
                  weights_mode="random", seed=0, device=str(dev), progress=False,
                  save_frequency=3, **options)
    out_dir.mkdir(parents=True, exist_ok=True)
    writes = []
    real_write = api._write_checkpoint

    def timed_write(path, data):
        t0 = time.perf_counter()
        real_write(path, data)
        writes.append(time.perf_counter() - t0)

    def run(tag, **kw):
        t0 = time.perf_counter()
        n = sum(1 for _ in api.clip_guided_diffusion(prefix_path=out_dir / tag, **kwargs, **kw))
        return n, time.perf_counter() - t0

    def final(tag):
        """The run's last frame and its x (the checkpoint written after its
        last segment)."""
        return frames.by_dir[str(out_dir / tag)][-1], np.load(out_dir / f"{tag}.npz")["x"]

    first = _FirstStep(api, dev)
    frames = _Frames(api)
    api._write_checkpoint = timed_write
    try:
        n_a, s_a = run("A", checkpoint_path=str(out_dir / "A.npz"))
        gen = api.clip_guided_diffusion(prefix_path=out_dir / "B", **kwargs,
                                        checkpoint_path=str(out_dir / "B_part.npz"))
        next(gen), next(gen)
        gen.close()
        part = dict(np.load(out_dir / "B_part.npz"))
        n_b, _ = run("B", resume_from=str(out_dir / "B_part.npz"),
                     checkpoint_path=str(out_dir / "B.npz"))
        run("C", checkpoint_path=str(out_dir / "C.npz"))
        ctrl = dict(part, generator=torch.Generator(dev).manual_seed(0).get_state().numpy())
        np.savez(out_dir / "ctrl_part.npz", **ctrl)
        run("ctrl", resume_from=str(out_dir / "ctrl_part.npz"),
            checkpoint_path=str(out_dir / "ctrl.npz"))
        refused = None
        if options.get("dpm_solver"):  # the DPM state must not cross into a DDIM run
            try:
                list(api.clip_guided_diffusion(
                    prefix_path=out_dir / "no_dpm", **{**kwargs, "dpm_solver": False},
                    resume_from=str(out_dir / "B_part.npz")))
            except ValueError as e:
                refused = str(e).splitlines()[0]
            if refused is None:
                raise AssertionError(f"phase 13{sub}: a DPM checkpoint resumed without dpm_solver")
    finally:
        api._write_checkpoint = real_write
        frames.close()
        first.close()
    (fa, xa), (fb, xb), (fc, xc), (fk, xk) = (final(t) for t in ("A", "B", "C", "ctrl"))
    if not all(np.isfinite(v).all() for v in (fa, xa, fb, xb)):
        raise AssertionError(f"phase 13{sub}: non-finite frames or x")
    if int(part["next_seg"]) != 2 or n_b != n_a - 2:
        raise AssertionError(f"phase 13{sub}: B's checkpoint at segment {int(part['next_seg'])}, "
                             f"the resumed run wrote {n_b} of {n_a} frames")
    ab = max(_diff(fa, fc), _diff(xa, xc))
    ares = max(_diff(fa, fb), _diff(xa, xb))
    actrl = max(_diff(fa, fk), _diff(xa, xk))
    verdict = _hold_resumed(f"phase 13{sub}", ab, ares, actrl)
    size_b = (out_dir / "A.npz").stat().st_size
    what = "DPM-Solver++(2M), x0p across the checkpoint" if options.get("dpm_solver") else "bf16"
    _say13(sub, f"resume at {size}px {what}, ddim10, save_frequency 3 (4 segments): max |A - C| "
                f"{ab:.3e}, max |A - resumed B| {ares:.3e} ({verdict}), the fresh-state control "
                f"{actrl:.3e}; checkpoint {size_b} bytes (the generator's state "
                f"{part['generator'].size} of them), written in "
                f"{1e3 * float(np.mean(writes)):.2f} ms of host time per segment "
                f"({len(writes)} writes); run A {s_a:.2f} s"
                + (f"; without dpm_solver: ValueError '{refused}'" if refused else ""))
    shutil.rmtree(out_dir, ignore_errors=True)
    return ab == 0.0


class _HolderLock:
    """The daemon's device lock, remembering which thread holds it."""

    def __init__(self):
        import threading

        self.lock, self.holder = threading.Lock(), None

    def acquire(self, *a, **kw):
        import threading

        if self.lock.acquire(*a, **kw):
            self.holder = threading.get_ident()
            return True
        return False

    def release(self):
        self.holder = None
        self.lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _RequestLaunches(dict):
    """A launch counter that also counts by request: installed over
    ``LAUNCHES`` of the kernel modules while requests overlap. A launch
    from a Python thread counts for that thread (a request's handler);
    one from a thread PyTorch made (the autograd engine's worker, where
    every backward runs) for the holder of the device lock, the request
    whose sampling runs. ``by_request[ident][name]``."""

    def __init__(self, base: dict, by_request: dict, lock: _HolderLock):
        super().__init__(base)
        self.by_request, self.lock = by_request, lock

    def __setitem__(self, name, value):
        import threading

        delta = value - self.get(name, 0)
        if delta > 0:
            if isinstance(threading.current_thread(), threading._DummyThread):
                who = self.lock.holder
            else:
                who = threading.get_ident()
            per = self.by_request.setdefault(who, {})
            per[name] = per.get(name, 0) + delta
        super().__setitem__(name, value)


def phase_serve(k3, kattn, dev, out_dir: Path, deterministic: bool) -> None:
    """Phase 13c: ``cgd_tpu_torch.serve`` on the card, in a thread on a free
    port, ``--weights-mode random --warmup 128:ddim10:16 --stall-timeout
    600`` (the zero-init layers re-drawn): healthz; two lone then two
    overlapping 128px ddim10 requests (one plain, one ``stream`` with
    save_frequency 5), each final frame held to a direct API call with the
    same seed and keywords (bit-equal where phase 13a found the card
    deterministic, else relative L2 <= F32_STEP_TOL), the wall times;
    an f32 request overlapping a bf16 one: its final frame within relative
    L2 F32_STEP_TOL of a lone f32 API run (with PyTorch's default TF32
    flags in the process, which the f32 request must turn off and the
    other must not turn back on), and no bf16 kernel among its launches
    (``_RequestLaunches``); 400 for a request without a prompt on both paths; one
    request on a second daemon with ``--mesh cut=2`` over the card given
    twice, launching K-halo. Every server is shut down on every exit."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from cgd_tpu_torch import api, serve
    from cgd_tpu_torch.io_utils.images import decode_png
    from cgd_tpu_torch.parallel import mesh as pmesh
    from cgd_tpu_torch.validate import FINAL_FRAME_ONLY

    out_dir.mkdir(parents=True, exist_ok=True)
    base = dict(image_size=128, timestep_respacing="ddim10", num_cutouts=16)
    servers = []

    def start(argv):
        t0 = time.perf_counter()
        srv = serve.make_server(["--port", "0", "--weights-mode", "random",
                                 "--stall-timeout", "600", *argv])
        servers.append(srv)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{srv.server_address[1]}", time.perf_counter() - t0

    def post(url, payload, results=None, key=None):
        req = urllib.request.Request(f"{url}/generate", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                body, ctype = r.read(), r.headers["Content-Type"]
            out = (r.status, ctype, body, time.perf_counter() - t0)
        except urllib.error.HTTPError as e:
            out = (e.code, e.headers["Content-Type"], e.read(), time.perf_counter() - t0)
        if results is not None:
            results[key] = out
        return out

    def last_png(status, ctype, body, _s):
        if status != 200:
            raise AssertionError(f"phase 13c: status {status}: {body[:300]!r}")
        if ctype.startswith("multipart/"):
            parts = [p for p in body.split(b"--cgdframe") if b"Content-Type: image/png" in p]
            if b"application/json" in body or not body.rstrip().endswith(b"--cgdframe--"):
                raise AssertionError("phase 13c: the stream ended with an error part")
            return decode_png(parts[-1].split(b"\r\n\r\n", 1)[1][:-2]), len(parts)
        return decode_png(body), 1

    def direct(seed, save_frequency, **kw):
        paths = [p for _, p in api.clip_guided_diffusion(
            prompts=[f"served {seed}"], **base, seed=seed, weights_mode="random",
            device=str(dev), progress=False, save_frequency=save_frequency,
            prefix_path=out_dir / f"direct_{seed}", **kw)]
        with open(paths[-1], "rb") as f:
            return decode_png(f.read())

    def hold(name, served, ref, f32=False):
        d = _diff(served, ref)
        rel = float(np.linalg.norm(served.astype(np.float64) - ref) / np.linalg.norm(ref))
        if (deterministic and not f32 and d != 0.0) or rel > F32_STEP_TOL:
            raise AssertionError(f"phase 13c: {name} vs its direct API run: max |diff| {d} "
                                 f"(of 255), rel L2 {rel:.3e}")
        return f"{name} max |diff| {d:.0f} / 255, rel L2 {rel:.3e}"

    plain = dict(base, prompt="served 1", seed=1)
    stream = dict(base, prompt="served 2", seed=2, stream=True, save_frequency=5)
    f32 = dict(base, prompt="served 3", seed=3, compute_dtype="float32")
    first = _FirstStep(api, dev)
    real_visible = pmesh.visible_devices
    real_counts, real_lock = (k3.LAUNCHES, kattn.LAUNCHES), serve._DEVICE_LOCK
    # PyTorch's defaults (cuDNN at TF32): what an f32 request must turn off,
    # and another request must not turn back on under it
    real_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        url, warm_s = start(["--warmup", "128:ddim10:16"])
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("backend") != "cuda" or health.get("devices", 0) < 1:
            raise AssertionError(f"phase 13c: healthz {health}")
        lone = {k: post(url, p) for k, p in (("plain", plain), ("stream", stream))}
        both = {}
        threads = [threading.Thread(target=post, args=(url, p, both, k))
                   for k, p in (("plain", plain), ("stream", stream))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        both_s = time.perf_counter() - t0
        ref_plain = direct(1, FINAL_FRAME_ONLY)
        ref_stream = direct(2, 5)
        lines = []
        for tag, results in (("lone", lone), ("overlapped", both)):
            img_p, _ = last_png(*results["plain"])
            img_s, n_parts = last_png(*results["stream"])
            if n_parts != 3:
                raise AssertionError(f"phase 13c: the stream sent {n_parts} frames, not 3")
            lines.append(f"{tag}: {hold('plain', img_p, ref_plain)}, "
                         f"{hold('stream', img_s, ref_stream)}")

        # an f32 request overlapping a bf16 one, launches counted by request
        by_thread, lock = {}, _HolderLock()
        serve._DEVICE_LOCK = lock
        k3.LAUNCHES = _RequestLaunches(real_counts[0], by_thread, lock)
        kattn.LAUNCHES = _RequestLaunches(real_counts[1], by_thread, lock)
        mixed = {}
        threads = [threading.Thread(target=post, args=(url, p, mixed, k))
                   for k, p in (("f32", f32), ("bf16", dict(plain, seed=4)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        k3.LAUNCHES, kattn.LAUNCHES = real_counts
        serve._DEVICE_LOCK = real_lock
        img_f32, _ = last_png(*mixed["f32"])
        last_png(*mixed["bf16"])
        ref_f32 = direct(3, FINAL_FRAME_ONLY, compute_dtype="float32")
        f32_line = hold("f32", img_f32, ref_f32, f32=True)
        f32_threads = [c for c in by_thread.values() if any(k.endswith("_f32") for k in c)]
        if len(f32_threads) != 1:
            raise AssertionError(f"phase 13c: f32 launches by {len(f32_threads)} requests: "
                                 f"{by_thread}")
        bf16_in_f32 = {k: v for k, v in f32_threads[0].items() if not k.endswith("_f32")}
        if bf16_in_f32 or not all(f32_threads[0].get(k) for k in (
                "conv3x3_fwd_f32", "conv3x3_dx_f32", "attn_fwd_f32", "attn_bwd_f32")):
            raise AssertionError(f"phase 13c: the f32 request's launches {f32_threads[0]}")

        bad = [post(url, {"image_size": 128}), post(url, {"stream": True})]
        if [b[0] for b in bad] != [400, 400] or any(b"prompt" not in b[2] for b in bad):
            raise AssertionError(f"phase 13c: no-prompt requests gave {[b[:3] for b in bad]}")

        pmesh.visible_devices = lambda kind="cuda": [dev, dev]
        mesh_url, _ = start(["--mesh", "cut=2"])
        _reset_launches(k3, kattn)
        img_m, _ = last_png(*post(mesh_url, dict(plain, seed=5)))
        mesh_launches = _launches(k3, kattn)
        _check_launched(mesh_launches, ("conv3x3_fwd_halo", "attn_fwd", "attn_bwd"), "phase 13c")
        if not np.isfinite(img_m).all() or img_m.shape != (128, 128, 3):
            raise AssertionError("phase 13c: the mesh request's frame")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = real_tf32
        k3.LAUNCHES, kattn.LAUNCHES = real_counts
        serve._DEVICE_LOCK = real_lock
        pmesh.visible_devices = real_visible
        first.close()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    lone_sum = lone["plain"][3] + lone["stream"][3]
    _say13("c", f"serve --warmup 128:ddim10:16 --stall-timeout 600: started in {warm_s:.2f} s "
                f"(the warmup's run, the kernels already built by phase 2); healthz {health}; "
                f"128px ddim10 requests: lone plain {lone['plain'][3]:.2f} s, lone stream "
                f"{lone['stream'][3]:.2f} s (sum {lone_sum:.2f} s), overlapped plain "
                f"{both['plain'][3]:.2f} s and stream {both['stream'][3]:.2f} s, "
                f"{both_s:.2f} s for both ({both_s / lone_sum:.2f} of the lone sum); "
                f"{'; '.join(lines)}; f32 overlapping bf16: {f32_line}, its launches "
                f"{f32_threads[0]}; no prompt: 400 on both paths; --mesh cut=2 (the card "
                f"twice): launches {mesh_launches}; the stall detector never fired")
    shutil.rmtree(out_dir, ignore_errors=True)


def phase_cli_options(k3, kattn, dev, out_dir: Path, deterministic: bool) -> None:
    """Phase 13d: ``cgd_tpu_torch.cli.main`` at 128px ddim10 (the zero-init
    layers re-drawn) with ``-gif -mp4 --log-losses --profile DIR
    --checkpoint P``: whether each mux wrote a file, the frames deleted only
    if both did, the trace naming a ``cgd::`` kernel, one loss line per
    guided step; then the same CLI with ``--checkpoint Q`` interrupted
    after its fourth frame and ``--resume Q``: its last frame held to the
    uninterrupted run's under the determinism rule."""
    import contextlib
    import io

    import numpy as np

    from cgd_tpu_torch import api, cli
    from cgd_tpu_torch.io_utils.images import clean_and_combine_prompts

    out_dir.mkdir(parents=True, exist_ok=True)
    argv = ["--prompts", "|".join(PROMPTS), "-size", "128", "-cutn", "16", "-respace", "ddim10",
            "--weights-mode", "random"]
    frames = _Frames(api)
    first = _FirstStep(api, dev)
    real_loop = api.sample_loop

    def stop_after_four(*a, **kw):
        for i, item in enumerate(real_loop(*a, **kw)):
            yield item
            if i == 3:
                raise KeyboardInterrupt

    buf = io.StringIO()
    try:
        _reset_launches(k3, kattn)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main([*argv, "-gif", "-mp4", "--log-losses", "--profile", str(out_dir / "prof"),
                      "--checkpoint", str(out_dir / "full.npz"), "-dir", str(out_dir / "full")])
        full_s = time.perf_counter() - t0
        launches = _launches(k3, kattn)
        api.sample_loop = stop_after_four
        cli.main([*argv, "-q", "--checkpoint", str(out_dir / "part.npz"),
                  "-dir", str(out_dir / "part")])
        api.sample_loop = real_loop
        cli.main([*argv, "-q", "--resume", str(out_dir / "part.npz"),
                  "-dir", str(out_dir / "resumed")])
    finally:
        api.sample_loop = real_loop
        frames.close()
        first.close()
    out = buf.getvalue()
    print(out, end="")
    frame_dir = clean_and_combine_prompts(out_dir / "full", PROMPTS, 0)
    gif, mp4 = Path(f"{frame_dir}_00.gif"), Path(f"{frame_dir}_00.mp4")
    pngs = sorted((out_dir / "full").rglob("*.png"))
    both = gif.is_file() and mp4.is_file()
    if both != (not pngs) or (not both and len(pngs) != 10):
        raise AssertionError(f"phase 13d: gif {gif.is_file()}, mp4 {mp4.is_file()}, "
                             f"{len(pngs)} frames left")
    trace = out_dir / "prof" / "trace.json"
    text = trace.read_text() if trace.is_file() else ""
    if "cgd::" not in text or f"Profile trace written to {out_dir / 'prof'}" not in out:
        raise AssertionError(f"phase 13d: the profile trace {trace} names no cgd:: kernel")
    loss_lines = [ln for ln in out.splitlines() if ln.startswith("CLIP Loss: ")]
    if len(loss_lines) != 10 or not all("Total Loss: " in ln for ln in loss_lines):
        raise AssertionError(f"phase 13d: {len(loss_lines)} loss lines, not 10")
    full_last = frames.by_dir[str(out_dir / "full")][-1]
    res = frames.by_dir[str(out_dir / "resumed")]
    if len(frames.by_dir[str(out_dir / "part")]) != 4 or len(res) != 6:
        raise AssertionError("phase 13d: the interrupted / resumed runs' frame counts")
    d = _diff(full_last, res[-1])
    if (deterministic and d != 0.0) or not np.isfinite(res[-1]).all():
        raise AssertionError(f"phase 13d: the resumed CLI run's last frame differs by {d:.3e}")
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "phase 13d")
    _say13("d", f"CLI 128px ddim10 -gif -mp4 --log-losses --profile --checkpoint: "
                f"{full_s:.2f} s per image incl. model setup and the trace's export "
                f"({trace.stat().st_size} bytes); gif written {gif.is_file()}, mp4 written "
                f"{mp4.is_file()}, {len(pngs)} frames kept; {len(loss_lines)} loss lines "
                f"({loss_lines[0][:60]}...); --resume from the fourth frame: last frame max "
                f"|diff| {d:.3e} to the uninterrupted run's; launches {launches}")
    shutil.rmtree(out_dir, ignore_errors=True)


def phase_13(k3, kattn, dev) -> None:
    """Phase 13, in order: (a) resume at 256px bf16, (b) resume of a 128px
    DPM-Solver++(2M) run, (c) the daemon, (d) the CLI's options."""
    t0 = time.perf_counter()
    out = ROOT / "outputs" / "chip_smoke_13"
    deterministic = phase_resume(dev, out / "resume256", 256, "a")
    phase_resume(dev, out / "resume_dpm", 128, "b", dpm_solver=True)
    phase_serve(k3, kattn, dev, out / "serve", deterministic)
    phase_cli_options(k3, kattn, dev, out / "cli", deterministic)
    _say13("", f"phase 13 wall time {time.perf_counter() - t0:.1f} s")


def main() -> None:
    t_start = time.perf_counter()
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
    global CARD
    CARD = smi
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
    # what ptxas said of the attention kernels (their consumers must not
    # spill) and of the f32 conv body (f32conv::conv3x3_f32_kernel<BN, UP, EPI>)
    for line in _attn_ptxas(_build.ptxas_log(), ("attn", "attn32", "f32conv")):
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
    res["conv3x3_dx_wtiled"] = phase_dx_wtiled(k3, dev)
    res["conv3x3_fwd_f32"] = phase_kernels_f32(k3, dev)
    res.update(phase_attention(kattn, dev))
    res["conv3x3_fwd_halo"] = phase_halo(k3, dev)
    phase_unet(dev, 256)
    phase_unet(dev, 512)
    phase_unet(dev, 128)
    phase_lpips(k3, dev)
    phase_split_unet(dev)
    _, step_s, peak_256 = phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke")
    phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_128", size=128)
    launches = phase_cli(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_512")
    mesh_launches, mesh_step_s, _ = phase_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_mesh",
                                           mesh=make_mesh([dev, dev]), unsplit_step_s=step_s)
    launches["conv3x3_fwd_halo"] = mesh_launches["conv3x3_fwd_halo"]
    ckpt_launches = phase_checkpoints(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_ckpts",
                                      step_s)
    launches["conv3x3_fwd_f32"] = ckpt_launches["conv3x3_fwd_f32"]
    f32 = phase_f32_kernels(k3, kattn, dev)
    res["conv3x3_fwd_f32"]["err"] = max(res["conv3x3_fwd_f32"]["err"],
                                        f32.pop("conv3x3_fwd_f32")["err"])
    res.update(f32)
    phase_f32_unets(k3, kattn, dev)
    f32_launches, f32_step_s = phase_f32_e2e(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_f32",
                                             step_s)
    for name in ("conv3x3_dx_f32", "attn_fwd_f32", "attn_bwd_f32"):
        launches[name] = f32_launches[name]
    res["conv3x3_fwd_halo_f32"] = phase_halo_f32(k3, dev)
    phase_split_unet_f32(k3, dev)
    mesh_f32_launches, _ = phase_f32_e2e(
        k3, kattn, dev, ROOT / "outputs" / "chip_smoke_f32_mesh", mesh_step_s,
        mesh=make_mesh([dev, dev]), f32_step_s=f32_step_s, say=_say10)
    launches["conv3x3_fwd_halo_f32"] = mesh_f32_launches["conv3x3_fwd_halo_f32"]
    phase_f32_mesh_cli(k3, kattn, dev, ROOT / "outputs" / "chip_smoke_f32_mesh_cli")
    phase_12(k3, kattn, dev, step_s, peak_256)
    phase_13(k3, kattn, dev)

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
                            "cgd_tpu/kernels/conv_pallas.py:364 (f32: the LPIPS VGG, "
                            "compute_dtype float32)"),
        "conv3x3_dx_f32": ("cgd_tpu_torch/csrc/conv3x3_f32.cu",
                           "cgd_tpu/kernels/conv_pallas.py:779 and :680 (f32)"),
        "attn_fwd_f32": ("cgd_tpu_torch/csrc/attn_f32.cu",
                         "cgd_tpu/kernels/attention_pallas.py:69 (f32)"),
        "attn_bwd_f32": ("cgd_tpu_torch/csrc/attn_f32.cu",
                         "cgd_tpu/kernels/attention_pallas.py:82 (f32)"),
        "conv3x3_fwd_halo_f32": ("cgd_tpu_torch/csrc/conv3x3_f32.cu",
                                 "cgd_tpu/kernels/conv_pallas.py:364 (explicit_halo at f32, via "
                                 "cgd_tpu/kernels/conv_spmd.py:139)"),
    }
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": res[name]["err"],
         # a device time the profiler did not record (nan) is null: not measured
         **{k: None if res[name][k] != res[name][k] else res[name][k] for k in keys}}
        for name, (src, rep) in meta.items()
    ]
    print(f"[11] device readings still far under their CUDA-event time in a fresh process "
          f"(marked *): {MARKED or 'none'}")
    print(f"[11] chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s, the kernels' "
          "build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
