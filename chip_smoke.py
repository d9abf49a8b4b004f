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
   with ragged T and batches at d = 192 / 256; and at d = 16 and 32, the
   toy models', zero-padded per head to the 64-wide template, in bf16 and
   f32), checking that K-dx, K-dx-w
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
   step's 39 launches; K-bn (``kernels.bn_act``) forward and backward at
   CLIP RN50x16's site shapes (16 cutouts of 384^2: the largest site, a
   bn1 / bn2 site, the stem's NCHW view and a down-projection site), bf16
   and f32, against its plain version run on the card (the f32-island
   chain and autograd's backward of it; bit-equal required, reruns
   bit-identical), timed beside the chain with its bound in bytes;
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
   the plain routing before and after it, the run's peak device memory, and
   K-bn's launches (counters reset just before the run): 123 each way a
   guided step (83 in mode a, 36 in b, 4 in c);
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
   final frame and x (both must be 0; the control must differ), the
   checkpoint's bytes and the host ms a segment its write takes; (b) the same at 128px with DPM-Solver++(2M)
   (x0p across the checkpoint), whose checkpoint a run without
   ``dpm_solver`` refuses; (c) ``cgd_tpu_torch.serve`` in a thread on a
   free port (``--warmup 128:ddim10:16 --stall-timeout 600``): healthz,
   two lone then two overlapping 128px ddim10 requests (plain, and a
   stream at save_frequency 5) each bit-equal to a direct API run, an f32
   request overlapping a bf16 one (bit-equal to a lone f32 run, no bf16
   kernel among its launches, with PyTorch's default TF32 flags in the
   process), 400 without a prompt on both paths, and a request on a
   second daemon with ``--mesh cut=2`` over the card twice launching
   K-halo; (d) ``cli.main`` at 128px ddim10 with ``-gif -mp4 --log-losses
   --profile DIR --checkpoint P`` (a mux each, frames deleted only if both
   wrote, a trace naming a ``cgd::`` kernel, one loss line per guided
   step), then interrupted after its fourth frame and ``--resume``d: the
   last frame bit-equal to the uninterrupted run's;
14. batch > 1 and the memory policy, every line with the card's name and
   power limit: (a) every launch class at b = 2, 4 and 8 (and where the
   bf16 plan still splits K at 8, the first b where it does not), bf16
   and f32: K-fwd in phase 3's modes and the 8^2 level, K-dx (K-dx-w at
   512^2) with its per-image dA / dB, K-halo on two-image shards, the
   attention at N = B * heads; each against its plain version, each image
   against the kernel on that image alone (bit-equal where the plan's
   split K is the same), with its plan and ms per image beside b = 1; (b)
   the 256px ViT-B/32 ddim25 run at ``batch_size=4``, bf16 and f32: the
   first step against the plain routing, a frame directory per image, ms
   per step, device busy and idle share and peak memory beside b = 1, then
   the ``data=2`` mesh at batch 2 and ``data=2, cut=2`` at batch 4 on the
   one card against the unsplit runs; (c) the memory grid through
   ``tools/profile_step.measure``: 512px RN50x16 at b = 1 x 16 cutouts
   (the full grid, b 1-8 x 16 / 32 cutouts, was a one-off calibration of
   the gate, recorded in PERF.md), remat off / full / hires128, peak
   memory and ms per step (each under 90% of the card's memory), the
   smallest point where the port's gate engages, and remat full against off at
   256px b = 2 (the same x after three steps; the recompute's launches one
   forward's); (d) resume under ``CGD_TPU_REMAT=1``: the recorded
   ``unet_remat`` adopted with the variable unset, bit-equal, and a
   checkpoint without the key resumed as false; (e) BASELINE.md's
   acceptance configs 2-5 through ``tools/run_acceptance.run_config`` (a
   fresh CLI process each) at 10-25 steps;
15. the measuring and validation tools (``cgd_tpu_torch/tools``), every
   line with the card's name and power limit: (a)
   ``time_components.measure_components(256)``: UNet forward, forward +
   input gradient and the guided step, counters reset just before and read
   just after; (b) ``bench --respace ddim25`` in a fresh process: its JSON
   line, ``flops_per_step`` equal to ``guided_step_flops``, 0 < ``mfu`` <=
   1; (c) ``clip_score`` of a phase-5 frame in a fresh process against the
   score computed here; (d) ``serve_throughput`` at 128px ddim10, both arms;
   (e) ``first_real_run --dry-run`` on the card with the toy models (the
   attention at d = 16); (f) the guided-quality proxy's ddim10 / dpm10 /
   fast10 arms on the card against the CPU;
16. reproducibility, the reference's rule: every line with the card's name
   and power limit: (a) the augmentation warp's backward at 16 cutouts of
   224^2: how many distinct bit patterns 10 runs give on the gather route
   it replaced (autograd's atomic ``scatter_add_``) and on K-warp-b
   (``csrc/warp_bwd.cu``; one required), of ``apply_augs``' input gradient
   and of one 64px guided step's gradient under ``use_augs``, with the
   API's loss scales and with the CLIP loss alone; then at that draw and at
   ``tools/warp_bench.long_draw`` (clamped corners of hundreds of pairs a
   tap): K-warp-i (``csrc/warp_index.cu``, the index) equal to its plain
   version run on the CPU, K-warp-b against its plain version run on the
   CPU on the same inputs (bit-equal), ten reruns one bit pattern, the
   segments, and (``tools/warp_bench.calls``) the times of K-warp-b, the
   index and its plain version on the card, the whole route, the gather route's backward,
   ``index_put_(accumulate=True)`` on the same pairs and a stable
   ``torch.sort`` of the bins; (b) phase 13a's
   resume at 64px with ``use_augs`` (the augmentations drawn from the
   generator), with the API's loss scales and with the CLIP loss alone,
   bit-equal; (c) two runs of 3 guided steps each, x compared bit for bit,
   at 256px: ``use_augs`` (the API's loss scales, and the CLIP loss alone;
   each also on the gather route, a control), the init image with LPIPS
   and an image prompt, and with ``use_augs`` the ``cut=2`` mesh on the one
   card, ``compute_dtype="float32"``, fast guidance and ``batch_size=4``,
   and at 512px RN50x16 (its convs on cuDNN; the API's loss scales and the
   CLIP loss alone, and with ``use_augs``: the warp at 16 cutouts of
   384^2); every one must be bit-equal, every ``use_augs`` run
   must launch K-warp-i and K-warp-b, and
   ``torch.use_deterministic_algorithms`` must stay off.

Each phase's seconds are printed at the end.

Prints a JSON line of per-kernel results (launches from phase 6, K-bn's
among them, K-halo's from phase 7c, K-fwd f32's from phase 8, K-dx f32's
and the f32 attention's from phase 9c, K-halo f32's from phase 10c,
K-warp-b's and K-warp-i's from phase 16c's ``use_augs`` run; each with
its eager and device time, its bound on the card and the library call's
time where there is one; K-fwd f32's summed over one guided step's 39
launches; K-bn's at its largest site, against the chain it replaced), the
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
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
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


# phase 3's attention rows at head dims between the templates (batch, N, T,
# d): the toy 64px UNet's four heads of 16 at 32^2 (CGD_TPU_DEBUG_TINY=1,
# phase 15e) and d = 32
ATTN_PADDED = [(1, 4, 1024, 16), (1, 2, 256, 32)]


def phase_attention_padded(kattn, dev, cases=ATTN_PADDED, tag="3") -> None:
    """Phase 3's rows at d = 16 and 32: K-attn-f and K-attn-b in bf16 and
    f32, each head zero-padded by the wrappers to the 64-wide template with
    the true d's 1/sqrt(d) scale, against their plain versions at the true
    width (ATTN_TOL in bf16, F32_TOL in f32), the backward's reruns
    bit-identical, the launches counted under the true d; the kernels'
    device time (torch.profiler, held to the call's CUDA-event time) and
    eager time (CUDA events around 20 calls) beside SDPA's on the same q, k,
    v (``attn_bench.calls``), the plain version's and the bound of the
    unpadded work."""
    import torch

    from cgd_tpu_torch.tools import attn_bench

    gen = torch.Generator(dev).manual_seed(4322)
    for dtype, tol, peak in ((torch.bfloat16, ATTN_TOL, PEAK_BF16_FLOPS),
                             (torch.float32, F32_TOL, PEAK_TF32_FLOPS)):
        f32 = dtype == torch.float32
        for bt, n, t, d in cases:
            qkv = torch.randn(bt, t, 3 * n * d, generator=gen, device=dev).to(dtype)
            g = torch.randn(bt, t, n * d, generator=gen, device=dev).to(dtype)
            q, k, v = kattn.split_heads(qkv, n)
            kattn.reset_launch_counts()
            out, lse = kattn.attention_fwd(qkv, n)
            dqkv = kattn.attention_bwd(qkv, out, lse, g, n)
            by_d = dict(kattn.LAUNCHES_BY_D[d])
            suffix = "_f32" if f32 else ""
            if by_d[f"attn_fwd{suffix}"] != 1 or by_d[f"attn_bwd{suffix}"] != 1:
                raise AssertionError(f"K-attn d = {d}: launches {by_d}, expected one each")
            err, rel = _rel_max(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), bt))
            name = f"{'f32' if f32 else 'bf16'} B{bt} N{n} T{t} d{d}"
            if rel > tol:
                raise AssertionError(f"K-attn-f {name}: {rel:.3e} > {tol}")
            if not torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, n)):
                raise AssertionError(f"K-attn-b {name}: repeated runs differ")
            line = []
            for part, a, b in zip(("dq", "dk", "dv"), dqkv.chunk(3, dim=-1),
                                  kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g, n))):
                e, r = _rel_max(a, kattn.merge_heads(b, bt))
                line.append(f"{part} {e:.3e} ({r:.2e})")
                if r > tol:
                    raise AssertionError(f"K-attn-b {name} {part}: {r:.3e} > {tol}")
            gh = kattn.to_heads(g, n)
            fns = attn_bench.calls(kattn, n, t, d, dev, dtype)  # kernels and SDPA, batch 1
            dname = "float32" if f32 else "bfloat16"
            dev_ms = {key: _device_ms(fn, _attn_fresh(n, t, d, key, dname), f"{key} {name}")
                      for key, fn in fns.items()}
            eager = {key: _time_ms(fn) for key, fn in fns.items()}
            plain = {"fwd": _time_ms(lambda: kattn.attention_fwd_plain(q, k, v)),
                     "bwd": _time_ms(lambda: kattn.attention_bwd_plain(q, k, v, gh))}
            bdf = _bound(4 * n * t * t * d, _nbytes(qkv, out, lse), peak)
            bdb = _bound(10 * n * t * t * d, _nbytes(qkv, out, lse, g, dqkv), peak)
            print(f"[{tag}] K-attn {name} (padded to d = {kattn.kernel_head_dim(d)}, "
                  f"scale 1/sqrt({d})): fwd max|err| {err:.3e} ({rel:.2e}), {', '.join(line)} "
                  f"(bit-identical reruns; launches under d = {d}: {by_d}; SDPA backend "
                  f"{_sdpa_backend(*(z[None].contiguous() for z in (q, k, v)))})")
            for key, kern, sdpa, bd in (("fwd", "K-attn-f", "SDPA fwd", bdf),
                                        ("bwd", "K-attn-b", "SDPA bwd", bdb)):
                print(f"[{tag}]   {key}: kernel device {dev_ms[kern]:.4f} ms, eager "
                      f"{eager[kern]:.4f} ms; SDPA device {dev_ms[sdpa]:.4f} ms, eager "
                      f"{eager[sdpa]:.4f} ms; plain {plain[key]:.4f} ms"
                      f"{_fmt(bd, dev_ms[kern])}")
    torch.cuda.synchronize()


# phase 3's K-bn sites of CLIP RN50x16 at BN_ACT_CUTOUTS cutouts of 384^2
# (name, H = W, C, mode, layout): the largest site (bn3 and its identity),
# a bn1 / bn2 site, the stem's (an NCHW tensor seen as NHWC: the element
# path) and a down-projection site
BN_ACT_CUTOUTS = 16
# K-bn's launches each way in one guided RN50x16 step, by mode (phase 6)
BN_ACT_PER_STEP = (("a", 83), ("b", 36), ("c", 4))
BN_ACT_SITES = (("96x384b", 96, 384, "b", "nhwc"), ("96x96a", 96, 96, "a", "nhwc"),
                ("192x48a-stem", 192, 48, "a", "nchw"), ("48x768c", 48, 768, "c", "nhwc"))


def bn_act_bytes(n: int, itemsize: int, mode: str, bwd: bool) -> int:
    """K-bn's bytes a call of n elements: forward reads x (and the identity
    in modes b and c) and writes y; backward reads y and dy and writes dx
    (and the identity's gradient in modes b and c)."""
    arrays = (4 if mode != "a" else 3) if bwd else (3 if mode != "a" else 2)
    return arrays * n * itemsize


def phase_bn_act(dev, tag="3") -> dict:
    """Phase 3's K-bn rows: ``kernels.bn_act``'s forward and backward on the
    card against its plain version run on the card (``bn_act_plain``, the
    f32-island chain, and autograd's backward of it) at BN_ACT_SITES, bf16
    and f32: bit-equal (required), reruns bit-identical; each timed by CUDA
    events and by its device time beside the chain's, with its bound in
    bytes over the HBM bandwidth. Returns the rows ``bn_act_fwd`` /
    ``bn_act_bwd``: the largest error over every case, the times at the
    largest site in bf16."""
    import torch

    from cgd_tpu_torch.kernels import bn_act as kbn

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    gen = torch.Generator(dev).manual_seed(4323)
    res = {"bn_act_fwd": {"err": 0.0, "library_ms": None},
           "bn_act_bwd": {"err": 0.0, "library_ms": None}}
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, c, mode, layout in BN_ACT_SITES:
            def act():
                t = torch.randn(BN_ACT_CUTOUTS, h, h, c, generator=gen, device=dev).to(dtype)
                return (t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                        if layout == "nchw" else t)

            x, dy = act(), act()
            r = act() if mode != "a" else None
            s = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
            b = 0.1 * torch.randn(c, generator=gen, device=dev)
            sd, bd = (s.flip(0), b.flip(0)) if mode == "c" else (None, None)
            xg = x.detach().requires_grad_(True)
            rg = None if r is None else r.detach().requires_grad_(True)
            graph = kbn.bn_act_plain(xg, s, b, rg, sd, bd)
            leaves = [t for t in (xg, rg) if t is not None]
            want = (graph.detach(), *torch.autograd.grad(graph, leaves, dy, retain_graph=True))

            calls = {
                "fwd": lambda: kbn.bn_act_fwd(x, s, b, r, sd, bd),
                "bwd": lambda: kbn.bn_act_bwd(y, dy, s, mode, sd),
            }
            kbn.reset_launch_counts()
            y = calls["fwd"]()
            got = (y, *(t for t in calls["bwd"]() if t is not None))
            if kbn.LAUNCHES[f"bn_act_fwd_{mode}"] != 1 or kbn.LAUNCHES[f"bn_act_bwd_{mode}"] != 1:
                raise AssertionError(f"K-bn {name}: launches {kbn.LAUNCHES}, expected one each way")
            again = (calls["fwd"](), *(t for t in calls["bwd"]() if t is not None))
            tdt = "bf16" if dtype == torch.bfloat16 else "f32"
            for part, g, w, a in zip(("y", "dx", "d identity"), got, want, again):
                err = _rel_max(g, w)[0]
                row = res["bn_act_fwd" if part == "y" else "bn_act_bwd"]
                row["err"] = max(row["err"], err)
                if not torch.equal(bits(g), bits(w)):
                    raise AssertionError(f"K-bn {name} {tdt} {part}: not bit-equal to the chain "
                                         f"(max |err| {err:.3e})")
                if not torch.equal(bits(g), bits(a)):
                    raise AssertionError(f"K-bn {name} {tdt} {part}: repeated runs differ")

            def plain_fwd():
                with torch.no_grad():
                    kbn.bn_act_plain(x, s, b, r, sd, bd)

            plains = {"fwd": plain_fwd,
                      "bwd": lambda: torch.autograd.grad(graph, leaves, dy, retain_graph=True)}
            n = x.numel()
            for way in ("fwd", "bwd"):
                ms = _time_ms(calls[way])
                dms = _device_ms(calls[way], label=f"K-bn {way} {name} {tdt}")
                pms = _time_ms(plains[way])
                pdms, pk, _ = _checked(plains[way], label=f"chain {way} {name} {tdt}")
                bd_ = _bound(0, bn_act_bytes(n, x.element_size(), mode, way == "bwd"))
                print(f"[{tag}] K-bn {way} {tdt} {BN_ACT_CUTOUTS}x{h}^2x{c} mode {mode} "
                      f"({layout}): bit-equal to the chain, bit-identical reruns; kernel "
                      f"{ms:.4f} ms, device {dms:.4f} ms; the chain {pms:.4f} ms, device "
                      f"{pdms:.4f} ms in {pk:g} kernels{_fmt(bd_, dms)}")
                if (name, dtype) == (BN_ACT_SITES[0][0], torch.bfloat16):
                    res[f"bn_act_{way}"].update(ms=ms, device_ms=dms, plain_ms=pms, **bd_)
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
    (the generator keeps its frame and ends), or with ``stop=N`` after its
    N-th yielded step. ``last`` records each run's x after its last yielded
    step, when the run ends."""

    def __init__(self, api, dev, stop: int = 0):
        import torch

        self.api, self.x, self.last, self.stop = api, [], [], stop
        self.real = api.resolve_unet, api.sample_loop

        def resolve_redrawn(*a, **kw):
            unet, *rest = self.real[0](*a, **kw)
            _redraw_zero_init(unet, torch.Generator(dev).manual_seed(9))
            return (unet, *rest)

        def spy(*a, **kw):
            n, x = 0, None
            try:
                for item in self.real[1](*a, **kw):
                    x = item[2]
                    if n == 0:
                        self.x.append(x.detach().float().clone())
                    yield item
                    n += 1
                    if n == self.stop:
                        raise KeyboardInterrupt
            finally:
                self.last.append(None if x is None else x.detach().float().clone())

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
    """Every kernel's launches: the conv family's, the attention's, the
    augmentation warp's (K-warp-b, K-warp-i) and K-bn's by direction and
    mode."""
    from cgd_tpu_torch.kernels import bn_act, warp

    return {**k3.LAUNCHES, **kattn.LAUNCHES, **warp.LAUNCHES, **bn_act.LAUNCHES}


def _reset_launches(k3, kattn) -> None:
    from cgd_tpu_torch.kernels import bn_act, warp

    k3.reset_launch_counts()
    kattn.reset_launch_counts()
    warp.reset_launch_counts()
    bn_act.reset_launch_counts()


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
    # K-bn at every one of RN50x16's 123 sites, once each way a guided step
    bn = {k: v / 25 for k, v in launches.items() if k.startswith("bn_act_")}
    if bn != {f"bn_act_{way}_{m}": n for way in ("fwd", "bwd") for m, n in BN_ACT_PER_STEP}:
        raise AssertionError(f"phase 6: K-bn's launches per guided step {bn}, not "
                             f"{dict(BN_ACT_PER_STEP)} each way")
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
        weights.clear_model_cache()  # and not the models the call kept on the card
        t1 = time.perf_counter()
        with weights.cache_counts() as counts:
            loaded = (weights.resolve_unet(256, True, "auto", device=dev,
                                           checkpoints_dir=str(ckpts))[0],
                      weights.resolve_clip("ViT-B/32", "auto", dev, str(ckpts))[0],
                      weights.resolve_lpips("auto", dev, str(ckpts)))
        hit_s = time.perf_counter() - t1
    finally:
        api.log_image, torch_lpips.CACHE_PATH = real_log_image, real_cache
        tokenizer._DEFAULT_TOKENIZER = real_tok
    if counts != {"hits": 0, "misses": 3}:
        raise AssertionError(f"phase 8: the caches' read back was served from kept models: {counts}")
    for name, written, back in zip(("UNet", "CLIP", "LPIPS"), (unet, clip, lpips), loaded):
        a, b = written.state_dict(), back.state_dict()
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k].cpu()) for k in a):
            raise AssertionError(f"phase 8: the {name} read back from its cache is not the "
                                 "written one")
    del loaded
    weights.clear_model_cache()  # the later phases' memory as without this phase
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


def _numpy_draw(dev, n: int, h: int, w: int, c: int, rs):
    """One set of augmentation draws for n cutouts of h x w x c from the
    numpy ``RandomState`` rs (``draw_augs``' fields, ranges and order)."""
    import numpy as np
    import torch

    from cgd_tpu_torch.guidance.cutouts import AugDraws

    lim = 0.4 / max(h, w)
    arrays = (rs.rand(n) < 0.5, rs.uniform(-15, 15, n), rs.uniform(-0.1, 0.1, n),
              rs.uniform(-0.1, 0.1, n), rs.rand(n) < 0.7, rs.uniform(-lim, lim, (n, 2)),
              rs.rand(n) < 0.15, rs.randn(n, h, w, c))
    return AugDraws(*(torch.as_tensor(a if a.dtype == bool else a.astype(np.float32), device=dev)
                      for a in arrays))


def _numpy_aug_draws(dev, calls: int = 25, n: int = 16, size: int = 224):
    """A draw_augs stand-in whose draws come from numpy, made up front (one
    set per call of a 25-step run, for n cutouts of size^2 x 3) and handed
    out in call order; ``reset`` starts a run again, so two runs see the
    same augmentations at the same steps."""
    import numpy as np

    rs = np.random.RandomState(1000)
    sets = [_numpy_draw(dev, n, size, size, 3, rs) for _ in range(calls)]
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

            def loss_fn(x, out, blend, gen):
                guided.append((blend.ref_t, meta.cutn, tuple(x.shape)))
                return fns.loss_fn(x, out, blend, gen)

            # it records on the host at every guided step: never replayed
            return fns._replace(loss_fn=loss_fn, host_reads=True)

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


def _hold_resumed(phase: str, ab: float, ares: float, actrl: float) -> None:
    """The determinism rule, the reference's: two uninterrupted runs are
    bit-equal, and so are the resumed run and the uninterrupted one; the
    control (the generator state overwritten by a fresh ``manual_seed``)
    differs."""
    if ab != 0.0:
        raise AssertionError(f"{phase}: two uninterrupted runs differ by {ab:.3e}")
    if ares != 0.0:
        raise AssertionError(f"{phase}: the resumed run differs by {ares:.3e}")
    if not actrl > 0.0:
        raise AssertionError(f"{phase}: the resume with a fresh generator state does not differ")


def phase_resume(dev, out_dir: Path, size: int, sub: str, phase: str = "13", **options) -> None:
    """Phases 13a (256px, bf16), 13b (128px DPM-Solver++(2M)) and 16b (64px,
    ``use_augs``; ``phase="16"``): ddim10,
    save_frequency 3, the zero-init layers re-drawn, through the API. Run A
    uninterrupted with ``checkpoint_path``; run B the same, closed after its
    second frame, then resumed from B's checkpoint to the end; run C a
    second uninterrupted run; and the control, B's checkpoint with its
    generator state overwritten by a fresh ``manual_seed(0)``. max |A - C|
    and max |A - resumed B| over the final frame and x are held to the
    determinism rule (``_hold_resumed``: both 0). Prints the checkpoint's
    size and the host ms per segment its write takes."""
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
                raise AssertionError(f"phase {phase}{sub}: a DPM checkpoint resumed without "
                                     "dpm_solver")
    finally:
        api._write_checkpoint = real_write
        frames.close()
        first.close()
    (fa, xa), (fb, xb), (fc, xc), (fk, xk) = (final(t) for t in ("A", "B", "C", "ctrl"))
    if not all(np.isfinite(v).all() for v in (fa, xa, fb, xb)):
        raise AssertionError(f"phase {phase}{sub}: non-finite frames or x")
    if int(part["next_seg"]) != 2 or n_b != n_a - 2:
        raise AssertionError(f"phase {phase}{sub}: B's checkpoint at segment "
                             f"{int(part['next_seg'])}, the resumed run wrote {n_b} of {n_a} "
                             "frames")
    ab = max(_diff(fa, fc), _diff(xa, xc))
    ares = max(_diff(fa, fb), _diff(xa, xb))
    actrl = max(_diff(fa, fk), _diff(xa, xk))
    _hold_resumed(f"phase {phase}{sub}", ab, ares, actrl)
    size_b = (out_dir / "A.npz").stat().st_size
    what = ("DPM-Solver++(2M), x0p across the checkpoint" if options.get("dpm_solver")
            else "bf16, use_augs (the augmentations drawn from the generator)"
            + (", the CLIP loss alone" if options.get("tv_scale") == 0 else "")
            if options.get("use_augs") else "bf16")
    say = _say16 if phase == "16" else _say13
    say(sub, f"resume at {size}px {what}, ddim10, save_frequency 3 (4 segments): max |A - C| "
             f"{ab:.3e}, max |A - resumed B| {ares:.3e} (bit-equal), the fresh-state control "
             f"{actrl:.3e}; checkpoint {size_b} bytes (the generator's state "
             f"{part['generator'].size} of them), written in "
             f"{1e3 * float(np.mean(writes)):.2f} ms of host time per segment "
             f"({len(writes)} writes); run A {s_a:.2f} s"
             + (f"; without dpm_solver: ValueError '{refused}'" if refused else ""))
    shutil.rmtree(out_dir, ignore_errors=True)


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


def phase_serve(k3, kattn, dev, out_dir: Path) -> None:
    """Phase 13c: ``cgd_tpu_torch.serve`` on the card, in a thread on a free
    port, ``--weights-mode random --warmup 128:ddim10:16 --stall-timeout
    600`` (the zero-init layers re-drawn): healthz; two lone then two
    overlapping 128px ddim10 requests (one plain, one ``stream`` with
    save_frequency 5), each final frame held to a direct API call with the
    same seed and keywords (bit-equal), the wall times;
    an f32 request overlapping a bf16 one: its final frame bit-equal to a
    lone f32 API run's (with PyTorch's default TF32
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

    def hold(name, served, ref):
        d = _diff(served, ref)
        if d != 0.0:
            raise AssertionError(f"phase 13c: {name} vs its direct API run: max |diff| {d} "
                                 "(of 255)")
        return f"{name} bit-equal"

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
        f32_line = hold("f32", img_f32, ref_f32)
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


def phase_cli_options(k3, kattn, dev, out_dir: Path) -> None:
    """Phase 13d: ``cgd_tpu_torch.cli.main`` at 128px ddim10 (the zero-init
    layers re-drawn) with ``-gif -mp4 --log-losses --profile DIR
    --checkpoint P``: whether each mux wrote a file, the frames deleted only
    if both did, the trace naming a ``cgd::`` kernel, one loss line per
    guided step; then the same CLI with ``--checkpoint Q`` interrupted
    after its fourth frame and ``--resume Q``: its last frame bit-equal to
    the uninterrupted run's."""
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
    if d != 0.0 or not np.isfinite(res[-1]).all():
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
    phase_resume(dev, out / "resume256", 256, "a")
    phase_resume(dev, out / "resume_dpm", 128, "b", dpm_solver=True)
    phase_serve(k3, kattn, dev, out / "serve")
    phase_cli_options(k3, kattn, dev, out / "cli")
    _say13("", f"phase 13 wall time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: batch > 1 on the card and the memory policy it calls for
# ---------------------------------------------------------------------------

BATCHES = (2, 4, 8)
# phase 14a's conv rows: phase 3's and the 256px model's 8^2 level
BATCH_CONV_CASES = CONV_CASES + [("conv3x3_gn_silu_add", 8, 1024, 1024, True, True, False)]
# phase 14a's attention: (heads, T, d) of the 256px and 128px models
BATCH_ATTN = [(8, 1024, 64), (4, 1024, 128), (4, 256, 192), (4, 64, 256)]
# phase 14a's K-halo shards at two images a shard (name, shard H, W, cin,
# cout, prologue, skip): phase 7a's, then phase 10a's 8^2-level shards
BATCH_HALO = [
    ("conv3x3", 128, 256, 3, 256, False, False),
    ("conv3x3_gn_silu_add", 128, 256, 256, 256, True, True),
    ("conv3x3_gn_silu", 8, 16, 2048, 1024, True, False),
    ("conv3x3_gn_silu", 256, 512, 128, 128, True, False),
    ("conv3x3_gn_silu_add", 4, 8, 1024, 1024, True, True),
]


def _say14(sub: str, msg: str) -> None:
    """A phase-14 line, with the card and its power limit."""
    print(f"[14{sub}] {msg} ({CARD})")


def _hold_per_image(what: str, batched, alone, same_plan: bool, tol: float) -> str:
    """Each image of a batched call against the same call on that image
    alone (``alone[i]``, outputs in the order of ``batched``, each with a
    leading batch dim): bit-equal where the plans agree (no atomics: an
    image's tiles run the same code whatever the batch), else within ``tol``
    of the lone call's max (split K cut otherwise)."""
    import torch

    worst = 0.0
    for i, outs in enumerate(alone):
        for a, b in zip(batched, outs):
            if same_plan and not torch.equal(a[i:i + 1], b):
                raise AssertionError(f"{what}: image {i} differs from its lone call with the "
                                     f"same plan (max err {_rel_max(a[i:i + 1], b)[0]:.3e})")
            worst = max(worst, _rel_max(a[i:i + 1], b)[1])
    if worst > tol:
        raise AssertionError(f"{what}: an image differs from its lone call by {worst:.3e} of "
                             f"its max > {tol}")
    return "each image bit-equal to its lone call" if same_plan else (
        f"each image within {worst:.2e} of its lone call's max")


def _conv_plan_str(plan: dict, f32: bool) -> str:
    if f32:
        return (f"ksplit {plan['ksplit']}, tiles {plan['tile_grid']} on {plan['blocks']} "
                f"persistent blocks")
    return f"ksplit {plan['ksplit']}, grid {plan['grid']}"


def phase_batch_kernels(k3, kattn, dev) -> list:
    """Phase 14a: every launch class at b = 2, 4 and 8 images (and, where
    the bf16 plan still splits K at 8, at the first b where it no longer
    does), bf16 and f32: K-fwd in each of phase 3's modes and the 8^2
    level, K-dx (K-dx-w at 512^2) with its per-image dA / dB, K-halo and
    K-halo f32 through ``conv_spmd`` on two-image shards, and the attention
    at N = B * heads. Each against its plain version (bf16: 1% of the
    reference's max; f32: F32_TOL), and each image of the batch against the
    kernel on that image alone (``_hold_per_image``). Prints each plan
    (split K, grid) and the ms per image at b beside b = 1 (CUDA events).
    Returns the rows (for PERF.md) as dicts."""
    import torch

    from cgd_tpu_torch.kernels import conv_spmd

    gen = torch.Generator(dev).manual_seed(1414)
    sms = k3._sms(dev)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        tol, tag = (F32_TOL, "f32") if f32 else (FWD_TOL, "bf16")

        def rn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

        def f32n(*shape, base=0.0):
            return base + 0.2 * torch.randn(*shape, generator=gen, device=dev)

        for name, ho, ci, co, pro, sk, up in BATCH_CONV_CASES:
            hs = ho // 2 if up else ho

            def plan(b, dx=False):
                if f32:
                    return (k3.f32_plan(b, ho, ho, co, ci, dx=True, sms=sms) if dx else
                            k3.f32_plan(b, hs, hs, ci, co, up=up, sms=sms))
                return (k3.conv_plan(b, ho, ho, co, ci, sms=sms) if dx else
                        k3.conv_plan(b, hs, hs, ci, co, up, sms=sms))

            bs = BATCHES
            if plan(BATCHES[-1])["ksplit"] > 1:  # and the first batch without split K
                bs = BATCHES + (next(b for b in range(BATCHES[-1] + 1, 1024)
                                     if plan(b)["ksplit"] == 1),)
            n = max(bs)
            x, w, bias = rn(n, hs, hs, ci), rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
            A, B = (f32n(n, ci, base=1.0), f32n(n, ci)) if pro else (None, None)
            skip = rn(n, ho, ho, co) if sk else None
            g = rn(n, ho, ho, co)
            wt = k3._flip_t(w)

            def sl(t, lo, hi):  # a contiguous slice of the batch (no copy)
                return None if t is None else t[lo:hi]

            def fwd(lo, hi, plain=False):
                fn = k3.conv3x3_fwd_plain if plain else k3.conv3x3_fwd
                return (fn(sl(x, lo, hi), w, bias, sl(A, lo, hi), sl(B, lo, hi),
                           sl(skip, lo, hi), up),)

            def dx(lo, hi, plain=False):
                fn = k3.conv3x3_dx_plain if plain else k3.conv3x3_dx
                return fn(sl(g, lo, hi), wt, sl(x, lo, hi), sl(A, lo, hi), sl(B, lo, hi))

            side = f"{ho}^2 {ci}->{co}"
            kinds = [("K-fwd", fwd, False)]
            if pro and not up:
                kinds.append(("K-dx-w" if ho >= 512 else "K-dx", dx, True))
            for kind, call, is_dx in kinds:
                ms1 = _time_ms(lambda: call(0, 1))
                p1 = plan(1, is_dx)
                for b in bs:
                    got = call(0, b)
                    err = 0.0
                    for part, a, r in zip(("dx", "dA", "dB") if is_dx else ("out",), got,
                                          call(0, b, plain=True)):
                        e, rel = _rel_max(a, r)
                        err = max(err, e)
                        if rel > tol:
                            raise AssertionError(f"{kind} {tag} {name} {side} b={b} {part}: "
                                                 f"{rel:.3e} > {tol} against the plain version")
                    pb = plan(b, is_dx)
                    verdict = _hold_per_image(f"{kind} {tag} {name} {side} b={b}", got,
                                              [call(i, i + 1) for i in range(b)],
                                              pb["ksplit"] == p1["ksplit"], tol)
                    ms = _time_ms(lambda: call(0, b)) / b
                    _say14("a", f"{kind} {tag} {name:20s} {side} b={b}: max|err| vs plain "
                                f"{err:.3e}; {verdict}; {ms:.4f} ms per image (b=1 {ms1:.4f}: "
                                f"{ms / ms1:.2f}x); plan {_conv_plan_str(pb, f32)} (b=1: "
                                f"{_conv_plan_str(p1, f32)})")
                    rows.append(dict(kind=kind, dtype=tag, name=name, shape=side, b=b, ms=ms,
                                     ms1=ms1, ksplit=pb["ksplit"], ksplit1=p1["ksplit"]))

        # K-halo (f32: K-halo f32) on two shards of two images each
        for name, hs, wd, ci, co, pro, sk in BATCH_HALO:
            b = 2
            xs = [rn(b, hs, wd, ci) for _ in range(2)]
            w, bias = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
            A, B = (f32n(b, ci, base=1.0), f32n(b, ci)) if pro else (None, None)
            skips = [rn(b, hs, wd, co) for _ in range(2)] if sk else None
            gs = [rn(b, hs, wd, co) for _ in range(2)]

            def run(lo, hi, plain=False):
                def cut(ts):
                    return None if ts is None else [t[lo:hi] for t in ts]

                xs_ = [t.detach().requires_grad_(True) for t in cut(xs)]
                a_, b_ = (None, None) if A is None else (A[lo:hi], B[lo:hi])
                if plain:
                    outs = conv_spmd.conv3x3_shards_plain(xs_, w, bias, a_, b_, cut(skips))
                elif not pro:
                    outs = conv_spmd.conv3x3(xs_, w, bias)
                elif sk:
                    outs = conv_spmd.conv3x3_gn_silu_add(xs_, a_, b_, w, bias, cut(skips))
                else:
                    outs = conv_spmd.conv3x3_gn_silu(xs_, a_, b_, w, bias)
                dxs = torch.autograd.grad(outs, xs_, cut(gs))
                return torch.cat(outs, 1).detach(), torch.cat(dxs, 1)

            got, want = run(0, b), run(0, b, plain=True)
            for part, a, r in zip(("fwd", "dx"), got, want):
                err, rel = _rel_max(a, r)
                if rel > tol:
                    raise AssertionError(f"K-halo {tag} {name} shard {hs}x{wd} b={b} {part}: "
                                         f"{rel:.3e} > {tol} against the plain version")
            def halo_plan(bb, cin, cout):
                if f32:
                    return k3.f32_plan(bb, hs, wd, cin, cout, halo=True, sms=sms)
                return k3.conv_plan(bb, hs, wd, cin, cout, halo=True, sms=sms)

            plans = [halo_plan(bb, ci, co) for bb in (1, b)]
            # the backward's K-halo runs on the cotangent, Cout -> Cin
            same = all(halo_plan(1, i, o)["ksplit"] == halo_plan(b, i, o)["ksplit"]
                       for i, o in ((ci, co), (co, ci)))
            verdict = _hold_per_image(f"K-halo {tag} {name} shard {hs}x{wd} b={b}", got,
                                      [run(i, i + 1) for i in range(b)], same, tol)
            ms1, ms = _time_ms(lambda: run(0, 1)), _time_ms(lambda: run(0, b)) / b
            _say14("a", f"K-halo {tag} {name:20s} 2 shards {hs}x{wd} {ci}->{co}, b={b} (fwd + "
                        f"input grad): max|err| vs plain {err:.3e}; {verdict}; {ms:.4f} ms per "
                        f"image (b=1 {ms1:.4f}); plan {_conv_plan_str(plans[1], f32)} (b=1: "
                        f"{_conv_plan_str(plans[0], f32)})")
            rows.append(dict(kind="K-halo", dtype=tag, name=name, shape=f"{hs}x{wd} {ci}->{co}",
                             b=b, ms=ms, ms1=ms1, ksplit=plans[1]["ksplit"],
                             ksplit1=plans[0]["ksplit"]))

        # the attention at N = B * heads
        plan_of = kattn.f32_attn_plan if f32 else kattn.attn_plan
        atol = F32_TOL if f32 else ATTN_TOL
        for heads, t, d in BATCH_ATTN:
            n = BATCHES[-1]
            qkv, g = rn(n, t, 3 * heads * d), rn(n, t, heads * d)

            def attn(lo, hi):
                q_, g_ = qkv[lo:hi], g[lo:hi]
                out, lse = kattn.attention_fwd(q_, heads)
                return out, kattn.attention_bwd(q_, out, lse, g_, heads)

            def geometry(b):
                return {k: v for k, v in plan_of(b, heads, t, d).items() if k != "grid"}

            ms1 = _time_ms(lambda: attn(0, 1))
            for b in BATCHES:
                out, dqkv = attn(0, b)
                q, k, v = kattn.split_heads(qkv[:b], heads)
                err, rel = _rel_max(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), b))
                grads = kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g[:b], heads))
                rel_b = max(_rel_max(a, kattn.merge_heads(r, b))[1]
                            for a, r in zip(dqkv.chunk(3, dim=-1), grads))
                if max(rel, rel_b) > atol:
                    raise AssertionError(f"K-attn {tag} N={b}x{heads} T={t} d={d}: fwd {rel:.3e}"
                                         f", bwd {rel_b:.3e} > {atol} against the plain version")
                verdict = _hold_per_image(f"K-attn {tag} N={b}x{heads} T={t} d={d}",
                                          (out, dqkv), [attn(i, i + 1) for i in range(b)],
                                          geometry(b) == geometry(1), atol)
                ms = _time_ms(lambda: attn(0, b)) / b
                grid = plan_of(b, heads, t, d)["grid"]
                _say14("a", f"K-attn-f + K-attn-b {tag} N = {b} x {heads} heads, T {t}, d {d}: "
                            f"max rel err vs plain fwd {rel:.2e}, bwd {rel_b:.2e}; {verdict}; "
                            f"{ms:.4f} ms per image (b=1 {ms1:.4f}); grids {grid}")
                rows.append(dict(kind="K-attn", dtype=tag, name=f"heads {heads}",
                                 shape=f"T {t} d {d}", b=b, ms=ms, ms1=ms1))
    torch.cuda.synchronize()
    return rows


# the full grid (b 1, 2, 4, 8 x 16 / 32 cutouts) calibrated the remat gate
# once (PERF.md); the run keeps its smallest points and the gate's check
GRID_REMAT = ("off", "full", "hires128")
MEM_HEADROOM = 0.9  # a point must peak under this share of the card's memory


def phase_memory_grid(k3, kattn, dev) -> None:
    """Phase 14c: the memory grid through ``tools/profile_step.measure``:
    512px RN50x16 at b = 1 and 16 cutouts, remat off / full / hires128
    (three guided steps each): peak GiB, which must stay under
    MEM_HEADROOM of the card's memory, ms per step and the K-fwd launches
    a step (the recompute's). Then the smallest 512px 16-cutout
    batch where the port's gate (``api._resolve_remat``) engages, run under
    the gate, must peak under MEM_HEADROOM. Then at 256px b = 2 (the
    zero-init layers re-drawn) three guided steps with remat full and off
    must give the same x (bit-equal predicted: the recompute runs the same
    kernels on the same plans), and the K-fwd / K-attn-f launches full
    remat adds must be one forward's (a fast-guidance step's)."""
    import os

    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.tools.profile_step import MEASURE_STEPS, measure, remat_policy

    out = ROOT / "outputs" / "chip_smoke_14c"
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    limit = MEM_HEADROOM * total
    grid = {}
    for remat in GRID_REMAT:
        _reset_launches(k3, kattn)
        r = measure(512, "RN50x16", 1, 16, remat, device=str(dev), prefix=str(out))
        steps = MEASURE_STEPS + 1  # the launches count the first step too
        r["fwd_per_step"] = k3.LAUNCHES["conv3x3_fwd"] / steps
        r["dx_per_step"] = (k3.LAUNCHES["conv3x3_dx"] + k3.LAUNCHES["conv3x3_dx_wtiled"]) / steps
        grid[remat] = r
        if r["peak_gib"] > limit:
            raise AssertionError(f"phase 14c: b=1 cutn=16 remat {remat} peaked at "
                                 f"{r['peak_gib']:.2f} GiB > {limit:.1f}")
        _say14("c", f"512px RN50x16 b=1 cutn=16 remat {remat}: peak {r['peak_gib']:.2f} GiB, "
                    f"{r['ms']:.1f} ms per guided step; K-fwd {r['fwd_per_step']:g}, "
                    f"K-dx {r['dx_per_step']:g} launches a step")
    off = grid["off"]
    for remat in ("full", "hires128"):
        r = grid[remat]
        if r["dx_per_step"] != off["dx_per_step"] or not r["fwd_per_step"] > off["fwd_per_step"]:
            raise AssertionError(f"phase 14c: remat {remat} launched K-fwd "
                                 f"{r['fwd_per_step']:g} / K-dx {r['dx_per_step']:g} a step "
                                 f"against off's {off['fwd_per_step']:g} / "
                                 f"{off['dx_per_step']:g}")

    # the gate: the smallest batch where it engages at 512px, 16 cutouts
    saved = os.environ.pop("CGD_TPU_REMAT", None)
    try:
        b_gate = next(b for b in range(1, 257) if api._resolve_remat(512, b, 16))
        _reset_launches(k3, kattn)
        r = measure(512, "RN50x16", b_gate, 16, "auto", device=str(dev), prefix=str(out))
    finally:
        if saved is not None:
            os.environ["CGD_TPU_REMAT"] = saved
    fwd = k3.LAUNCHES["conv3x3_fwd"] / (MEASURE_STEPS + 1)
    if r["peak_gib"] > limit or fwd != grid["full"]["fwd_per_step"]:
        raise AssertionError(f"phase 14c: the gate's point b={b_gate} peaked at "
                             f"{r['peak_gib']:.2f} GiB (limit {limit:.1f}) with {fwd:g} K-fwd "
                             "launches a step (full remat's expected)")
    _say14("c", f"the gate engages at 512px 16 cutouts from b={b_gate}: remat full, peak "
                f"{r['peak_gib']:.2f} GiB (under {limit:.1f} of {total:.1f}), {r['ms']:.1f} ms "
                f"per guided step ({r['ms'] / b_gate:.1f} ms per image)")

    # remat full against off at 256px b = 2: the same x after three steps
    first = _FirstStep(api, dev)
    counts = {}
    try:
        for remat in ("off", "full", "fast"):
            _reset_launches(k3, kattn)
            with remat_policy("off" if remat == "fast" else remat):
                for _ in api.clip_guided_diffusion(
                        prompts=PROMPTS, image_size=256, num_cutouts=16, batch_size=2,
                        timestep_respacing="ddim3", save_frequency=3, weights_mode="random",
                        seed=0, device=str(dev), progress=False, prefix_path=out / remat,
                        fast_guidance=remat == "fast"):
                    pass
            counts[remat] = (k3.LAUNCHES["conv3x3_fwd"] / 3, kattn.LAUNCHES["attn_fwd"] / 3)
    finally:
        first.close()
    x_off, x_full = first.last[0], first.last[1]
    d = (x_full - x_off).abs().max().item()
    rel = ((x_full - x_off).norm() / x_off.norm()).item()
    if d != 0.0 and not rel <= 1e-5:
        raise AssertionError(f"phase 14c: 256px b=2 remat full vs off after three steps: rel L2 "
                             f"{rel:.3e} > 1e-5")
    extra = tuple(f - o for f, o in zip(counts["full"], counts["off"]))
    if extra != counts["fast"]:
        raise AssertionError(f"phase 14c: full remat added {extra} K-fwd / K-attn-f launches a "
                             f"step, one forward launches {counts['fast']}")
    _say14("c", f"256px b=2, three guided steps, remat full vs off: x max |diff| {d:.3e} "
                f"({'bit-equal' if d == 0.0 else f'rel L2 {rel:.3e}'}); K-fwd / K-attn-f "
                f"launches a step off {counts['off']}, full {counts['full']} (+{extra}: one "
                f"forward, as a fast-guidance step's {counts['fast']})")
    shutil.rmtree(out, ignore_errors=True)


# phase 14e: each acceptance config's respacing (and skip, frame frequency)
# cut so that it runs 10-25 steps: (respace, skip, freq) per config
ACCEPTANCE_CUT = {
    "cfg2_128_multiprompt": ("25", None, "10"),
    "cfg3_256_init_vgg": ("ddim25", "12", "5"),
    "cfg4_512_rn50x16": ("10", None, "5"),
    "cfg5_256_nonsquare_reduce_mp4": ("ddim25", None, "5"),
}


def _cut_argv(argv, respace, skip, freq):
    out = list(argv)
    for flag, value in (("-respace", respace), ("-skip", skip), ("-freq", freq)):
        if value is not None:
            out[out.index(flag) + 1] = value
    return out


def phase_acceptance(dev, out_dir: Path) -> None:
    """Phase 14e: BASELINE.md's acceptance configs 2-5 through
    ``cgd_tpu_torch.tools.run_acceptance.run_config`` (a fresh CLI process
    each, random weights), each with its respacing cut to 10-25 steps
    (ACCEPTANCE_CUT; the tool's CONFIGS are copied and rewritten here). Each
    must exit 0 and write its frames (cfg5: its MP4 where a muxer wrote it,
    else its frames); prints s per step including the process's setup."""
    import copy

    from cgd_tpu_torch.tools import run_acceptance

    out_dir.mkdir(parents=True, exist_ok=True)
    init_path = out_dir / "init_256.png"
    run_acceptance.make_init_image(init_path)
    for key, cfg in run_acceptance.CONFIGS.items():
        respace, skip, freq = ACCEPTANCE_CUT[key]
        cfg = copy.deepcopy(cfg)
        cfg["argv"] = _cut_argv(cfg["argv"], respace, skip, freq)
        steps = int(respace.removeprefix("ddim")) - int(skip or 0)
        if "-reduce" in cfg["argv"]:
            steps -= int(int(respace.removeprefix("ddim")) * 0.2)
        cfg["steps"] = steps
        rec = run_acceptance.run_config(key, cfg, out_dir, init_path, timeout=600)
        if rec["rc"] != 0 or not (rec["frames"] or rec["videos"]):
            raise AssertionError(f"phase 14e: {key} rc {rec['rc']}, {rec['frames']} frames, "
                                 f"videos {rec['videos']}: {rec.get('stderr_tail', '')}")
        if "-mp4" in cfg["argv"] and not rec["videos"] and rec["frames"] == 0:
            raise AssertionError(f"phase 14e: {key} wrote neither an MP4 nor its frames")
        _say14("e", f"{key} ({' '.join(cfg['argv'][2:])}): rc 0, {steps} steps in "
                    f"{rec['wall_s']} s with the process's setup ({rec['wall_s'] / steps:.3f} s "
                    f"per step), {rec['frames']} frames, videos {rec['videos']}")
    shutil.rmtree(out_dir, ignore_errors=True)


def phase_batch_e2e(k3, kattn, dev, out_dir: Path, step_s: float, peak: float) -> None:
    """Phase 14b: the 256px ViT-B/32 ddim25 guided run through
    ``api.clip_guided_diffusion`` at ``batch_size=4`` (the zero-init layers
    re-drawn), bf16 and f32: the first step's x against the plain routing's
    (BF16_STEP_TOL / F32_STEP_TOL), a frame directory per image, and over
    frames every 6 steps ms per guided step (steps 7-12, host clock,
    synchronised), device busy and idle share (torch.profiler, steps 13-18)
    and peak memory, beside the same at b = 1 and phase 5's step; the
    counters reset just before each run and read just after. Then the
    ``data=2`` mesh (``make_mesh([dev, dev], data=2)``) at batch 2 and the
    ``data=2, cut=2`` mesh (``make_mesh([dev] * 4, data=2)``: K-halo on
    two images a shard) at batch 4, bf16 and f32, their first step's x
    against the unsplit run's (5e-2 / 1e-3), launching K-halo and no
    unsplit conv."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cgd_tpu_torch import api
    from cgd_tpu_torch.io_utils.images import clean_and_combine_prompts
    from cgd_tpu_torch.ops.nn import kernel_routing
    from cgd_tpu_torch.parallel.mesh import make_mesh
    from cgd_tpu_torch.tools.profile_step import _kernel_events

    first = _FirstStep(api, dev)

    def run(batch, dtype, tag, mesh=None, timed=False):
        """A run's first step only, or (``timed``) frames at steps 0, 6, 12
        and 18: returns its numbers and launches."""
        kwargs = dict(prompts=PROMPTS, image_size=256, num_cutouts=16, batch_size=batch,
                      clip_model_name="ViT-B/32", timestep_respacing="ddim25",
                      save_frequency=6, weights_mode="random", seed=0, device=str(dev),
                      progress=False, compute_dtype=dtype, mesh=mesh,
                      prefix_path=out_dir / tag)
        _reset_launches(k3, kattn)
        torch.cuda.reset_peak_memory_stats(dev)
        gen = api.clip_guided_diffusion(**kwargs)
        stamps, prof = [], None
        for batch_idx, _ in gen:
            if batch_idx == batch - 1:  # a frame set written
                torch.cuda.synchronize(dev)
                stamps.append(time.perf_counter())
                if not timed or len(stamps) == 4:
                    break
                if len(stamps) == 3:
                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.__enter__()
        if prof is not None:
            prof.__exit__(None, None, None)
        gen.close()
        res = {"launches": _launches(k3, kattn), "peak": torch.cuda.max_memory_allocated(dev)}
        if timed:
            res["ms"] = (stamps[2] - stamps[1]) / 6 * 1e3
            busy = sum(e.device_time_total for e in _kernel_events(prof)) / 1e3 / 6
            res.update(busy=busy, idle=1 - busy / res["ms"])  # as profile_step reads it
        return res

    def rel_first(a: int, b: int) -> float:
        xa, xb = first.x[a], first.x[b]
        return ((xa - xb).norm() / xb.norm()).item()

    try:
        for dtype, tol in (("bfloat16", BF16_STEP_TOL), ("float32", F32_STEP_TOL)):
            f32 = dtype == "float32"
            with kernel_routing("plain"):
                run(4, dtype, f"plain_{dtype}")
            b4 = run(4, dtype, f"b4_{dtype}", timed=True)
            unsplit_b4 = len(first.x) - 1
            rel = rel_first(-1, -2)
            if not rel <= tol:
                raise AssertionError(f"phase 14b: b=4 {dtype} first step x vs the plain routing "
                                     f"rel L2 {rel:.3e} > {tol}")
            dirs = [Path(clean_and_combine_prompts(out_dir / f"b4_{dtype}", PROMPTS, i))
                    for i in range(4)]
            pngs = [sorted(d.glob("*.png")) for d in dirs]
            if [len(p) for p in pngs] != [4] * 4:
                raise AssertionError(f"phase 14b: frames per image directory "
                                     f"{[len(p) for p in pngs]}, expected 4 each")
            _check_pngs(pngs[-1])
            names = (("conv3x3_fwd_f32", "conv3x3_dx_f32", "attn_fwd_f32", "attn_bwd_f32")
                     if f32 else ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"))
            _check_launched(b4["launches"], names, f"phase 14b b=4 {dtype}")
            b1 = run(1, dtype, f"b1_{dtype}", timed=True)
            _say14("b", f"256px ViT-B/32 ddim25 {dtype}, batch 4: first step's x vs the plain "
                        f"routing rel L2 {rel:.3e} (bound {tol}); {b4['ms']:.1f} ms per guided "
                        f"step ({b4['ms'] / 4:.1f} ms per image; b=1 in this phase "
                        f"{b1['ms']:.1f} ms" + ("" if f32 else f", phase 5 {step_s * 1e3:.1f} ms")
                        + f"), device busy {b4['busy']:.1f} ms (idle {b4['idle']:.0%}; b=1 "
                        f"{b1['busy']:.1f} ms, idle {b1['idle']:.0%}), peak "
                        f"{b4['peak'] / 2**30:.2f} GiB (b=1 {b1['peak'] / 2**30:.2f}" +
                        ("" if f32 else f", phase 5 {peak / 2**30:.2f}") + f" GiB); four frame "
                        f"directories of 4 frames; launches {b4['launches']}")
            # the meshes against the unsplit run at the same batch
            run(2, dtype, f"b2_{dtype}")
            unsplit_b2 = len(first.x) - 1
            halo = "conv3x3_fwd_halo_f32" if f32 else "conv3x3_fwd_halo"
            for spec, batch, devices, ref in (("data=2", 2, [dev, dev], unsplit_b2),
                                               ("data=2,cut=2", 4, [dev] * 4, unsplit_b4)):
                mesh = make_mesh(devices, data=2)
                m = run(batch, dtype, f"mesh_{spec}_{dtype}", mesh=mesh)
                rel = rel_first(-1, ref)
                if not rel <= tol:
                    raise AssertionError(f"phase 14b: {spec} mesh b={batch} {dtype} first step "
                                         f"x vs unsplit rel L2 {rel:.3e} > {tol}")
                unsplit = {k: m["launches"][k] for k in ("conv3x3_fwd", "conv3x3_dx",
                                                         "conv3x3_dx_wtiled", "conv3x3_fwd_f32",
                                                         "conv3x3_dx_f32")}
                _check_launched(m["launches"], (halo,), f"phase 14b {spec}")
                if any(unsplit.values()):
                    raise AssertionError(f"phase 14b: the {spec} mesh launched unsplit convs "
                                         f"{unsplit}")
                _say14("b", f"mesh {spec} ({mesh.shape}, one card) batch {batch} {dtype}: "
                            f"first step's x vs the unsplit run rel L2 {rel:.3e} (bound {tol}); "
                            f"{m['launches'][halo]} K-halo launches, no unsplit conv")
    finally:
        first.close()
    shutil.rmtree(out_dir, ignore_errors=True)


def phase_remat_resume(k3, kattn, dev, out_dir: Path) -> None:
    """Phase 14d: resume under remat, 256px bf16 batch 2, ddim10,
    save_frequency 3, the zero-init layers re-drawn. Run A under
    ``CGD_TPU_REMAT=1`` uninterrupted and run B the same closed after its
    second frame: both checkpoints record ``unet_remat: true``. B resumed
    with the variable unset adopts it (its K-fwd / K-dx launch ratio A's)
    and ends bit-equal to A. Run C under ``CGD_TPU_REMAT=0``; B's
    checkpoint with the key removed (as the port wrote them before the
    key) resumes as false (C's launch ratio). Prints max |A - C|: remat
    against none over ten steps."""
    import os

    import numpy as np

    from cgd_tpu_torch import api

    out_dir.mkdir(parents=True, exist_ok=True)
    kwargs = dict(prompts=PROMPTS, image_size=256, num_cutouts=16, batch_size=2,
                  timestep_respacing="ddim10", save_frequency=3, weights_mode="random", seed=0,
                  device=str(dev), progress=False)
    saved_env = os.environ.pop("CGD_TPU_REMAT", None)
    first, frames = _FirstStep(api, dev), _Frames(api)

    def run(tag, env=None, stop=None, **kw):
        if env is None:
            os.environ.pop("CGD_TPU_REMAT", None)
        else:
            os.environ["CGD_TPU_REMAT"] = env
        _reset_launches(k3, kattn)
        gen = api.clip_guided_diffusion(prefix_path=out_dir / tag, **kwargs, **kw)
        for i, _ in enumerate(gen):
            if stop is not None and i + 1 == stop:
                break
        gen.close()
        dx = k3.LAUNCHES["conv3x3_dx"] + k3.LAUNCHES["conv3x3_dx_wtiled"]
        return k3.LAUNCHES["conv3x3_fwd"] / dx

    def meta(path):
        return json.loads(str(np.load(path)["meta"]))

    def final(tag):
        return frames.by_dir[str(out_dir / tag)][-1], np.load(out_dir / f"{tag}.npz")["x"]

    try:
        ratio_a = run("A", "1", checkpoint_path=str(out_dir / "A.npz"))
        run("B_part", "1", stop=4, checkpoint_path=str(out_dir / "B_part.npz"))
        recorded = meta(out_dir / "A.npz")["unet_remat"], meta(out_dir / "B_part.npz")["unet_remat"]
        if recorded != (True, True):
            raise AssertionError(f"phase 14d: CGD_TPU_REMAT=1 checkpoints record {recorded}")
        ratio_b = run("B", None, resume_from=str(out_dir / "B_part.npz"),
                      checkpoint_path=str(out_dir / "B.npz"))
        ratio_c = run("C", "0", checkpoint_path=str(out_dir / "C.npz"))
        rec = dict(np.load(out_dir / "B_part.npz"))
        legacy = meta(out_dir / "B_part.npz")
        del legacy["unet_remat"]
        rec["meta"] = json.dumps(legacy, sort_keys=True)
        np.savez(out_dir / "L_part.npz", **rec)
        ratio_l = run("L", None, resume_from=str(out_dir / "L_part.npz"),
                      checkpoint_path=str(out_dir / "L.npz"))
    finally:
        frames.close()
        first.close()
        if saved_env is None:
            os.environ.pop("CGD_TPU_REMAT", None)
        else:
            os.environ["CGD_TPU_REMAT"] = saved_env
    (fa, xa), (fb, xb), (fc, xc), (fl, xl) = (final(t) for t in ("A", "B", "C", "L"))
    ares, ac, al = max(_diff(fa, fb), _diff(xa, xb)), max(_diff(fa, fc), _diff(xa, xc)), \
        max(_diff(fc, fl), _diff(xc, xl))
    if ares != 0.0 or ratio_b != ratio_a:
        raise AssertionError(f"phase 14d: the resumed remat run differs by {ares:.3e} (K-fwd / "
                             f"K-dx {ratio_b:.3f}, run A {ratio_a:.3f})")
    if ratio_l != ratio_c or ratio_c >= ratio_a or meta(out_dir / "L.npz")["unet_remat"]:
        raise AssertionError(f"phase 14d: the checkpoint without the key resumed with K-fwd / "
                             f"K-dx {ratio_l:.3f} (no remat {ratio_c:.3f}, remat {ratio_a:.3f})")
    if not all(np.isfinite(v).all() for v in (fa, xa, fl, xl)):
        raise AssertionError("phase 14d: non-finite frames or x")
    _say14("d", f"256px bf16 batch 2, ddim10: CGD_TPU_REMAT=1 checkpoints record unet_remat "
                f"true; resumed with the variable unset: remat adopted (K-fwd / K-dx launches "
                f"{ratio_b:.3f}, run A {ratio_a:.3f}), max |A - resumed B| {ares:.3e} "
                f"(bit-equal); the checkpoint without the key resumed as false ({ratio_l:.3f}, "
                f"CGD_TPU_REMAT=0 {ratio_c:.3f}), max |C - resumed| {al:.3e}; remat against none "
                f"over ten steps: max |A - C| {ac:.3e}")
    shutil.rmtree(out_dir, ignore_errors=True)


def phase_14(k3, kattn, dev, step_s: float, peak: float) -> list:
    """Phase 14, in order: (a) the kernels at b = 2, 4, 8, (b) the batch-4
    guided run and the data meshes, (c) the memory grid and the gate, (d)
    resume under remat, (e) the acceptance configs through the CLI.
    Returns 14a's rows."""
    t0 = time.perf_counter()
    out = ROOT / "outputs" / "chip_smoke_14"
    rows = phase_batch_kernels(k3, kattn, dev)
    phase_batch_e2e(k3, kattn, dev, out / "batch", step_s, peak)
    phase_memory_grid(k3, kattn, dev)
    phase_remat_resume(k3, kattn, dev, out / "resume")
    phase_acceptance(dev, out / "acceptance")
    _say14("", f"phase 14 wall time {time.perf_counter() - t0:.1f} s")
    return rows


def _say15(sub: str, msg: str) -> None:
    """A phase-15 line, with the card and its power limit."""
    print(f"[15{sub}] ({CARD}) {msg}")


def _tool(args, timeout: float) -> str:
    """``python -m cgd_tpu_torch.tools.<args>`` from the checkout: its
    standard output (raises with its last output on a nonzero exit)."""
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(args)}: exit {res.returncode}\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    return res.stdout


PROXY_TOL = 1e-4  # relative L2 error, a proxy arm on the card against the CPU


def phase_15(k3, kattn, dev, step_s: float, frame: Path) -> None:
    """Phase 15, the JAX package's measuring and validation tools through
    their port (``cgd_tpu_torch/tools``), each line with the card and power
    limit: (a) ``time_components.measure_components(256)``, the launch
    counters reset just before and read just after (K-fwd, K-dx and the
    attention at d = 64 launched); (b) ``bench`` at 256px ddim25 in a fresh
    process: its JSON line, ``value`` finite, ``flops_per_step`` equal to
    ``guided_step_flops`` of the configuration, 0 < ``mfu`` <= 1; (c)
    ``clip_score`` of ``frame`` (a frame of phase 5) in a fresh process,
    within 1e-3 of the score computed here from the same decoded image; (d)
    ``serve_throughput`` at 128px ddim10, 3 requests from 2 clients, both
    arms (every response a PNG); (e) ``first_real_run --dry-run`` on the
    card, the toy models (the attention at d = 16, zero-padded to the
    64-wide template), every phase passing, the launches by head dim; (f)
    the guided-quality proxy's ddim10, dpm10 and fast10 arms on the card
    against the same arms on the CPU, TF32 off (relative L2 <= PROXY_TOL)."""
    import os

    import numpy as np
    import torch

    from cgd_tpu_torch.io_utils.images import decode_image
    from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS
    from cgd_tpu_torch.models.unet import UNetConfig
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP
    from cgd_tpu_torch.tools import (bench, clip_score, first_real_run, guided_quality_proxy,
                                     serve_throughput, time_components)
    from cgd_tpu_torch.weights import resolve_clip

    t0 = time.perf_counter()
    out = ROOT / "outputs" / "chip_smoke_15"
    shutil.rmtree(out, ignore_errors=True)

    _reset_launches(k3, kattn)
    ms = time_components.measure_components(256, str(dev), 10)
    launches = _launches(k3, kattn)
    _check_launched(launches, ("conv3x3_fwd", "conv3x3_dx", "attn_fwd", "attn_bwd"), "15a")
    if not kattn.LAUNCHES_BY_D[64]["attn_fwd"]:
        raise AssertionError("15a: no attention launch at d = 64")
    _say15("a", f"256px ViT-B/32, bf16: UNet forward {ms['fwd']:.3f} ms, forward + input "
                f"gradient {ms['fwd_grad']:.3f} ms, guided step (16 cutouts) {ms['step']:.3f} ms "
                f"(ms per call, min of 3 runs of 10); phase 5's step wall {step_s * 1e3:.1f} ms; "
                f"launches {launches}")

    line = _tool(["cgd_tpu_torch.tools.bench", "--respace", "ddim25", "--stall-timeout", "600"],
                 900).strip().splitlines()[-1]
    rec = json.loads(line)
    cfg = UNetConfig.from_flags(dict(DIFFUSION_LOOKUP["cond"][256]["model_flags"]))
    want = bench.guided_step_flops(cfg, CLIP_CONFIGS["ViT-B/32"], 256, 1, 16, False)
    if not (rec["value"] == rec["value"] and 0 < rec["value"] < float("inf")):
        raise AssertionError(f"15b: value {rec['value']} is not a finite time")
    if rec["flops_per_step"] != want:
        raise AssertionError(f"15b: flops_per_step {rec['flops_per_step']} != {want}")
    if not 0 < rec.get("mfu", -1) <= 1:
        raise AssertionError(f"15b: mfu {rec.get('mfu')} outside (0, 1]")
    _say15("b", f"bench --respace ddim25: {line}")

    prompt = PROMPTS[0].split(":")[0]
    line = _tool(["cgd_tpu_torch.tools.clip_score", "--prompt", prompt, "--weights-mode",
                  "random", "--device", "cuda", str(frame)], 600).strip().splitlines()[-1]
    sub = json.loads(line)["mean_clip_score"]
    model, ccfg = resolve_clip("ViT-B/32", "random", dev)
    here = float(clip_score.scores(model, clip_score.tokenize(prompt, ccfg, "random"),
                                   clip_score.prepare(decode_image(frame),
                                                      ccfg.input_resolution)[None])[0])
    del model
    if abs(sub - here) > 1e-3:
        raise AssertionError(f"15c: clip_score {sub} vs in-process {here}")
    _say15("c", f"clip_score of {frame.relative_to(ROOT)}: {line} (in-process {here:.6f}, "
                f"|diff| {abs(sub - here):.2e})")

    results = serve_throughput.run(["--size", "128", "--respace", "ddim10", "--requests", "3",
                                    "--concurrency", "2", "--arms", "before,after",
                                    "--timeout", "600"])
    for r in results:
        _say15("d", f"serve_throughput 128px ddim10, 3 requests, concurrency 2: {json.dumps(r)}")

    saved = os.environ.get("CGD_TPU_DEBUG_TINY")
    _reset_launches(k3, kattn)
    try:
        report = first_real_run.run(True, str(out / "first_real_run"), device=str(dev))
    finally:
        if saved is None:
            os.environ.pop("CGD_TPU_DEBUG_TINY", None)
        else:
            os.environ["CGD_TPU_DEBUG_TINY"] = saved
    by_d = {d: dict(n) for d, n in kattn.LAUNCHES_BY_D.items() if any(n.values())}
    if not (by_d.get(16, {}).get("attn_fwd") and by_d.get(16, {}).get("attn_bwd")):
        raise AssertionError(f"15e: no attention launch at d = 16: {by_d}")
    _say15("e", f"first_real_run --dry-run on {report['device']}: phases "
                f"{', '.join(report['phases'])} all PASS; clip score "
                f"{report['parity_table']['cgd_tpu_torch_clip_score']['mean_clip_score']:.4f}; "
                f"attention launches by head dim {by_d}; conv launches {dict(k3.LAUNCHES)}")

    xs = guided_quality_proxy.x_start()
    for mode in ("ddim", "dpm", "fast"):
        got = {}
        for d in (dev, torch.device("cpu")):
            model_fn, builder_for, _ = guided_quality_proxy.solver_parts(d)
            got[d.type] = guided_quality_proxy.run_arm(10, mode, model_fn, builder_for, xs,
                                                        device=d)
        rel = float(np.linalg.norm(got["cuda"] - got["cpu"]) / np.linalg.norm(got["cpu"]))
        if not rel <= PROXY_TOL:
            raise AssertionError(f"15f: proxy {mode}10 on the card vs the CPU: {rel:.3e}")
        _say15("f", f"guided-quality proxy {mode}10: card vs CPU rel L2 {rel:.3e} "
                    f"(bound {PROXY_TOL})")
    shutil.rmtree(out, ignore_errors=True)
    _say15("", f"phase 15 wall time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: reproducibility on the card (the augmentation warp's backward,
# resume with use_augs, a repeat sweep over the paths)
# ---------------------------------------------------------------------------

REPEATS = 10     # runs of each gradient whose distinct bit patterns phase 16a counts
# the guidance with the CLIP loss alone: with random weights the TV and range
# losses' gradients can hide the warp's atomics in a step's gradient
CLIP_ALONE = {"tv_scale": 0.0, "range_scale": 0.0}


def _say16(sub: str, msg: str) -> None:
    """A phase-16 line, with the card and its power limit."""
    print(f"[16{sub}] {msg} ({CARD})")


def _distinct(tensors) -> int:
    """How many distinct bit patterns there are among ``tensors``."""
    import hashlib

    return len({hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
                for t in tensors})


def _augs_grads(dev, runs: int, n: int, size: int) -> list:
    """``apply_augs``' input gradient, ``runs`` times, on the same cutouts,
    draw and cotangent (from a seeded generator on ``dev``)."""
    import torch

    from cgd_tpu_torch.guidance import cutouts

    gen = torch.Generator(dev).manual_seed(16)
    cuts = torch.rand(n, size, size, 3, generator=gen, device=dev)
    probe = torch.randn(n, size, size, 3, generator=gen, device=dev)
    draw = cutouts.draw_augs(gen, n, size, size, 3)
    grads = []
    for _ in range(runs):
        x = cuts.clone().requires_grad_(True)
        (cutouts.apply_augs(x, draw) * probe).sum().backward()
        grads.append(x.grad)
    return grads


def _step_grads(dev, runs: int, out_dir: Path, **scales) -> list:
    """One 64px guided step's gradient with respect to x (ViT-B/32, 16
    cutouts, ``use_augs`` with one numpy-drawn set of augmentations, random
    weights with the UNet's zero-init layers re-drawn), ``runs`` times
    inside one API run: at the first guided step the loss is built and
    differentiated again with the generator's state restored each time;
    then the run takes that step once and is interrupted. ``scales``: the
    API's loss scales to override."""
    import numpy as np
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.diffusion.sampler import GuidanceFns
    from cgd_tpu_torch.guidance import cutouts

    grads, fixed = [], []
    real = api.make_guidance_builder, cutouts.draw_augs

    def make(*a, **kw):
        builder = real[0](*a, **kw)

        def repeated(meta):
            fns = builder(meta)

            def loss_fn(x, out, blend, gen):
                if not grads:
                    state = gen.get_state()
                    for _ in range(runs):
                        gen.set_state(state)
                        loss, _ = fns.loss_fn(x, out, blend, gen)
                        grads.append(torch.autograd.grad(loss, x, retain_graph=True)[0])
                    gen.set_state(state)
                return fns.loss_fn(x, out, blend, gen)

            return GuidanceFns(loss_fn, fns.grad_transform)

        return repeated

    def draw(gen, n, h, w, c):
        if not fixed:
            fixed.append(_numpy_draw(dev, n, h, w, c, np.random.RandomState(1000)))
        return fixed[0]

    first = _FirstStep(api, dev, stop=1)
    api.make_guidance_builder, cutouts.draw_augs = make, draw
    try:
        for _ in api.clip_guided_diffusion(
                prompts=PROMPTS, image_size=64, num_cutouts=16, clip_model_name="ViT-B/32",
                timestep_respacing="ddim25", weights_mode="random", seed=0, device=str(dev),
                use_augs=True, progress=False, save_frequency=1, prefix_path=out_dir, **scales):
            pass
    finally:
        api.make_guidance_builder, cutouts.draw_augs = real
        first.close()
    if len(grads) != runs or not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"phase 16a: {len(grads)} step gradients of {runs}, or non-finite")
    return grads


def phase_warp(dev, out_dir: Path) -> dict:
    """Phase 16a: the augmentation warp's backward at the main path's 16
    cutouts of 224^2. How many distinct bit patterns REPEATS runs give, on
    the gather route (``warp.gather_warp`` under autograd: an atomic
    ``scatter_add_``) and on K-warp-b: of ``apply_augs``' input gradient
    with one fixed draw, and of one 64px guided step's gradient under
    ``use_augs``, with the API's loss scales and with the CLIP loss alone;
    K-warp-b must give one. Then at that draw and at
    ``warp_bench.long_draw`` (clamped corners of hundreds of pairs a tap),
    on the warp apply_augs built: K-warp-i's index equal to its plain
    version's run on the CPU, field by field, and one pattern in REPEATS
    runs; K-warp-b against its plain version run on the CPU on the same
    inputs (the same order: bit-equal, held; run on the card the plain
    version's ``index_add_`` is atomic, so its distance there is printed,
    not held), REPEATS reruns one pattern; the segments' lengths; and the
    times of ``warp_bench.calls``: K-warp-b (events, device), the index,
    the whole route (autograd on a kept graph, index included), the gather
    route's backward it replaced, ``index_put_(accumulate=True)`` on the
    same pairs (the library's sorted scatter: its distinct patterns and
    distance from K-warp-b too, at the main draw) and a stable
    ``torch.sort`` of the bins (the library call beside the index), with
    the plain versions' times. Returns the main draw's rows of K-warp-b
    and K-warp-i."""
    import torch

    from cgd_tpu_torch.kernels import warp
    from cgd_tpu_torch.tools import warp_bench

    n, size = 16, 224
    real = warp.bilinear_warp

    def on(route, fn, *a, **kw):
        warp.bilinear_warp = route
        try:
            return fn(*a, **kw)
        finally:
            warp.bilinear_warp = real

    counts, apart = {}, {}
    grads = [on(route, _augs_grads, dev, REPEATS, n, size) for route in (warp.gather_warp, real)]
    counts["augs"] = tuple(_distinct(g) for g in grads)
    apart["augs"] = _rel_max(grads[1][0], grads[0][0])[1]
    for key, scales in (("step", {}), ("step, CLIP loss alone", CLIP_ALONE)):
        grads = [on(route, _step_grads, dev, REPEATS, out_dir / f"{key}_{i}", **scales)
                 for i, route in enumerate((warp.gather_warp, real))]
        counts[key] = tuple(_distinct(g) for g in grads)
        apart[key] = _rel_max(grads[1][0], grads[0][0])[1]
    _say16("a", f"distinct bit patterns in {REPEATS} runs, the gather's autograd backward "
                f"(scatter_add_, atomic) / K-warp-b, and the two routes' first gradients "
                f"apart (of max): apply_augs' input gradient [{n}, {size}, {size}, 3] f32, one "
                f"fixed draw, {counts['augs'][0]} / {counts['augs'][1]} ({apart['augs']:.3e}); "
                f"one 64px guided step's gradient under use_augs (ViT-B/32, 16 cutouts, "
                f"numpy-drawn augmentations) with the API's loss scales {counts['step'][0]} / "
                f"{counts['step'][1]} ({apart['step']:.3e}), with the CLIP loss alone "
                f"{counts['step, CLIP loss alone'][0]} / {counts['step, CLIP loss alone'][1]} "
                f"({apart['step, CLIP loss alone']:.3e})")
    if any(c[1] != 1 for c in counts.values()):
        raise AssertionError(f"phase 16a: K-warp-b's gradients are not reproducible: {counts}")

    rows = {}
    for draw in warp_bench.DRAWS:
        fns = warp_bench.calls(draw, dev)
        w = fns["inputs"]
        idx, weight, g, index = w["idx"], w["weight"], w["g"], w["index"]
        tag = f"{draw} draw, {w['n']} cutouts of {w['size']}^2"
        plain_index = warp.warp_index_plain(idx.cpu(), weight.cpu())
        for name, got, want in zip(warp.WarpIndex._fields, index, plain_index):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"phase 16a: {tag}: K-warp-i's {name} differs from its "
                                     f"plain version's run on the CPU")
        index_patterns = _distinct(
            [torch.cat([t.reshape(-1).view(torch.int32) for t in warp.warp_index(idx, weight)])
             for _ in range(REPEATS)])
        out = warp.warp_bwd(g, index)
        patterns = _distinct([warp.warp_bwd(g, index) for _ in range(REPEATS)])
        if patterns != 1 or index_patterns != 1:
            raise AssertionError(f"phase 16a: {tag}: {index_patterns} / {patterns} distinct "
                                 f"K-warp-i / K-warp-b results in {REPEATS} runs")
        card_rel = _rel_max(out, warp.warp_bwd_plain(g, index))[1]
        cpu_plain = warp.warp_bwd_plain(g.cpu(), plain_index)
        err, rel = _rel_max(out.cpu(), cpu_plain)
        if not torch.equal(out.cpu(), cpu_plain):
            raise AssertionError(f"phase 16a: {tag}: K-warp-b vs its plain version (on the CPU, "
                                 f"the same inputs): max |err| {err:.3e} ({rel:.3e} of max), "
                                 "not bit-equal")
        starts = index.offsets.long()
        seg = (starts[warp.TAPS::warp.TAPS] - starts[:-1:warp.TAPS]).float()
        n_long = int(index.n_long)
        dms = {call: _device_ms(fns[call], lambda c=call: warp_bench.fresh(str(ROOT), draw, c),
                                f"{call}, {tag}") for call in warp_bench.CALLS}
        ms, index_ms = _time_ms(fns["kernel"]), _time_ms(fns["index"])
        plain_ms = _time_ms(lambda: warp.warp_bwd_plain(g, index))
        plain_index_ms = _time_ms(lambda: warp.warp_index_plain(idx, weight))
        # the function's bytes, whatever the index's layout
        bound = _bound(2 * idx.numel() * g.shape[1],
                       warp_bench.function_bytes(idx.numel(), *g.shape), PEAK_F32_FLOPS)
        index_bound = _bound(0, _nbytes(idx, weight, *index))
        _say16("a", f"{tag} (the warp apply_augs built on the card): K-warp-i's index equal "
                    f"to its plain version's run on the CPU (required), {index_patterns} pattern "
                    f"in {REPEATS} runs; K-warp-b vs its plain version run on the CPU on the same "
                    f"inputs max |err| {err:.3e} (bit-equal required), {patterns} pattern in "
                    f"{REPEATS} runs; the plain version run on the card (its index_add_ atomic, "
                    f"its order its own) {card_rel:.3e} of max away; segments: {int(seg.max())} "
                    f"pairs at most, a bin {int(starts.diff().max())}, {float(seg.mean()):.2f} on "
                    f"average, {n_long} over {warp.LONG_PAIRS}, {int((seg == 0).sum())} of "
                    f"{seg.numel()} empty")
        _say16("a", f"{tag}: K-warp-b {ms:.4f} ms (events), {dms['kernel']:.4f} ms device"
                    f"{_fmt(bound, dms['kernel'])}; plain version {plain_ms:.4f} ms; K-warp-i "
                    f"(the index) {index_ms:.4f} ms (events), {dms['index']:.4f} ms device"
                    f"{_fmt(index_bound, dms['index'])}, its plain version (stable torch.sort "
                    f"and a histogram) {plain_index_ms:.4f} ms (events), "
                    f"{dms['index_plain']:.4f} ms device, torch.sort of the bins alone "
                    f"{dms['sort']:.4f} ms device; the warp's backward, index included: "
                    f"{dms['route']:.4f} ms device, against the gather's autograd backward it "
                    f"replaced {dms['gather']:.4f} ms device; index_put_(accumulate=True) on the "
                    f"same pairs, products included, {dms['index_put']:.4f} ms device")
        if draw == "main":
            put = [fns["index_put"]() for _ in range(REPEATS)]
            put_rel = _rel_max(put[0], out)[1]
            _say16("a", f"{tag}: index_put_(accumulate=True) on the same pairs: "
                        f"{_distinct(put)} distinct bit patterns in {REPEATS} runs, "
                        f"{'bit-equal to' if torch.equal(put[0], out) else f'{put_rel:.3e} of max from'} "
                        f"K-warp-b")
            rows["warp_bwd"] = {"err": err, "ms": ms, "device_ms": dms["kernel"],
                                "plain_ms": plain_ms, "library_ms": dms["gather"], **bound}
            rows["warp_index"] = {"err": 0.0, "ms": index_ms, "device_ms": dms["index"],
                                  "plain_ms": plain_index_ms, "library_ms": dms["sort"],
                                  **index_bound}
    return rows


def phase_repeat_sweep(k3, kattn, dev, out_dir: Path, size: int = 256) -> dict:
    """Phase 16c: two runs of each configuration through the API, each
    interrupted after 3 guided steps (ddim25, 16 cutouts, ViT-B/32, random
    weights, the zero-init layers re-drawn), their x after the third step
    compared bit for bit: 256px with ``use_augs``, with the API's loss
    scales and with the CLIP loss alone; phase 8's init image with LPIPS and
    an image prompt (random weights; skip 12, init_scale 1000); and with
    ``use_augs``, each a path the warp's gradient runs through: the ``cut=2``
    mesh on the one card (the cutouts split over it),
    ``compute_dtype="float32"``, fast guidance, ``batch_size=4`` (64
    cutouts); and 512px RN50x16 (bf16, batch 1), whose convs run on cuDNN
    (its data-gradient algorithm is cuDNN's choice, with
    ``cudnn.deterministic`` left at PyTorch's default), with the API's loss
    scales and with the CLIP loss alone, and with ``use_augs`` (the warp's
    backward at 16 cutouts of 384^2, after cuDNN's). Every pair must be bit-equal, and
    every ``use_augs`` run must launch K-warp-i and K-warp-b. The first two
    cases run twice more on the gather route K-warp-b replaced, a control
    whose difference says whether the check can see the atomics. Counters
    reset just before each first run and read just after.
    ``torch.use_deterministic_algorithms`` (process-wide) must still be off
    at the end. Returns the launches of the first ``use_augs`` run."""
    import torch

    from cgd_tpu_torch import api
    from cgd_tpu_torch.io_utils.images import encode_png
    from cgd_tpu_torch.kernels import warp
    from cgd_tpu_torch.parallel.mesh import make_mesh

    out_dir.mkdir(parents=True, exist_ok=True)
    init_png, prompt_png = out_dir / "init.png", out_dir / "prompt.png"
    init_png.write_bytes(encode_png(_test_image(300, 260, 1)))
    prompt_png.write_bytes(encode_png(_test_image(224, 320, 2)))
    augs = dict(use_augs=True)
    cases = [  # (name, options, also on the gather route)
        ("use_augs", augs, True),
        ("use_augs, the CLIP loss alone", dict(**augs, **CLIP_ALONE), True),
        ("init image + LPIPS + image prompt",
         dict(init_image=str(init_png), skip_timesteps=12, init_scale=1000,
              image_prompts=[f"{prompt_png}:1"]), False),
        ("mesh cut=2 (the card twice), use_augs", dict(mesh=make_mesh([dev, dev]), **augs), False),
        ("compute_dtype float32, use_augs", dict(compute_dtype="float32", **augs), False),
        ("fast guidance, use_augs", dict(fast_guidance=True, **augs), False),
        ("batch_size 4, use_augs", dict(batch_size=4, **augs), False),
        ("RN50x16", dict(image_size=512, clip_model_name="RN50x16"), False),
        ("RN50x16, the CLIP loss alone",
         dict(image_size=512, clip_model_name="RN50x16", **CLIP_ALONE), False),
        ("RN50x16, use_augs", dict(image_size=512, clip_model_name="RN50x16", **augs), False),
    ]
    real = warp.bilinear_warp

    def two_runs(tag, options, route):
        """x after the third guided step of two runs, the first run's
        launches and its wall time."""
        first = _FirstStep(api, dev, stop=3)
        warp.bilinear_warp = route
        try:
            for run in range(2):
                if run == 0:
                    _reset_launches(k3, kattn)
                t0 = time.perf_counter()
                for _ in api.clip_guided_diffusion(**{
                        **dict(prompts=PROMPTS, image_size=size, num_cutouts=16,
                               timestep_respacing="ddim25", weights_mode="random", seed=0,
                               device=str(dev), progress=False, save_frequency=1,
                               prefix_path=out_dir / f"{tag}_{run}"), **options}):
                    pass
                torch.cuda.synchronize()
                if run == 0:
                    launches, wall = _launches(k3, kattn), time.perf_counter() - t0
        finally:
            warp.bilinear_warp = real
            first.close()
        return first.last[-2], first.last[-1], launches, wall

    lines, augs_launches = [], None
    for i, (name, options, control) in enumerate(cases):
        a, b, launches, wall = two_runs(i, options, real)
        if not torch.isfinite(a).all():
            raise AssertionError(f"phase 16c: {name}: non-finite x")
        if not torch.equal(a, b):
            raise AssertionError(f"phase 16c: {name}: two runs differ after 3 guided steps by "
                                 f"{(a - b).abs().max().item():.3e}")
        if options.get("use_augs"):
            _check_launched(launches, ("warp_index", "warp_bwd"), f"phase 16c {name}")
            augs_launches = augs_launches or launches
        said = ""
        if control:
            ga, gb, _, _ = two_runs(f"{i}g", options, warp.gather_warp)
            said = f"; the gather route's two runs {(ga - gb).abs().max().item():.3e} apart"
        lines.append(f"{options.get('image_size', size)}px {name}: bit-equal ({wall:.2f} s a "
                     f"run; launches "
                     f"{ {k: v for k, v in launches.items() if v} }){said}")
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("phase 16c: torch.use_deterministic_algorithms was switched on")
    for line in lines:
        _say16("c", f"two runs, x after 3 guided steps: {line}")
    _say16("c", "torch.use_deterministic_algorithms off, cudnn.deterministic "
                f"{torch.backends.cudnn.deterministic} (PyTorch's defaults)")
    shutil.rmtree(out_dir, ignore_errors=True)
    return augs_launches


def phase_16(k3, kattn, dev) -> tuple:
    """Phase 16, in order: (a) the warp's backward, (b) resume at 64px with
    ``use_augs``, (c) the repeat sweep. Returns (16a's rows of K-warp-b and
    K-warp-i, 16c's ``use_augs`` launches)."""
    t0 = time.perf_counter()
    out = ROOT / "outputs" / "chip_smoke_16"
    rows = phase_warp(dev, out / "warp")
    phase_resume(dev, out / "resume_augs", 64, "b", phase="16", use_augs=True)
    phase_resume(dev, out / "resume_augs_clip", 64, "b", phase="16", use_augs=True,
                 **CLIP_ALONE)
    launches = phase_repeat_sweep(k3, kattn, dev, out / "sweep")
    shutil.rmtree(out, ignore_errors=True)
    _say16("", f"phase 16 wall time {time.perf_counter() - t0:.1f} s")
    return rows, launches


PHASE_SECONDS = {}  # wall seconds by phase, printed at the end


def _timed(phase: str, fn, *a, **kw):
    """``fn(*a, **kw)``, its wall time added to ``phase``'s."""
    t0 = time.perf_counter()
    try:
        return fn(*a, **kw)
    finally:
        PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + time.perf_counter() - t0


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
    PHASE_SECONDS["2"] = time.perf_counter() - t0
    print(f"[2] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")
    # what ptxas said of the attention kernels (their consumers must not
    # spill), of the f32 conv body (f32conv::conv3x3_f32_kernel<BN, UP, EPI>)
    # and of the warp's backward and its index (warpb::, warpi::)
    for line in _attn_ptxas(_build.ptxas_log(), ("attn", "attn32", "f32conv", "warpb", "warpi")):
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

    res = _timed("3", phase_kernels, k3, dev)
    res["conv3x3_dx_wtiled"] = _timed("3", phase_dx_wtiled, k3, dev)
    res["conv3x3_fwd_f32"] = _timed("3", phase_kernels_f32, k3, dev)
    res.update(_timed("3", phase_attention, kattn, dev))
    _timed("3", phase_attention_padded, kattn, dev)
    res.update(_timed("3", phase_bn_act, dev))
    res["conv3x3_fwd_halo"] = _timed("7", phase_halo, k3, dev)
    for size in (256, 512, 128):
        _timed("4", phase_unet, dev, size)
    _timed("4", phase_lpips, k3, dev)
    _timed("7", phase_split_unet, dev)
    _, step_s, peak_256 = _timed("5", phase_e2e, k3, kattn, dev, ROOT / "outputs" / "chip_smoke")
    _timed("5", phase_e2e, k3, kattn, dev, ROOT / "outputs" / "chip_smoke_128", size=128)
    launches = _timed("6", phase_cli, k3, kattn, dev, ROOT / "outputs" / "chip_smoke_512")
    mesh_launches, mesh_step_s, _ = _timed(
        "7", phase_e2e, k3, kattn, dev, ROOT / "outputs" / "chip_smoke_mesh",
        mesh=make_mesh([dev, dev]), unsplit_step_s=step_s)
    launches["conv3x3_fwd_halo"] = mesh_launches["conv3x3_fwd_halo"]
    ckpt_launches = _timed("8", phase_checkpoints, k3, kattn, dev,
                           ROOT / "outputs" / "chip_smoke_ckpts", step_s)
    launches["conv3x3_fwd_f32"] = ckpt_launches["conv3x3_fwd_f32"]
    f32 = _timed("9", phase_f32_kernels, k3, kattn, dev)
    res["conv3x3_fwd_f32"]["err"] = max(res["conv3x3_fwd_f32"]["err"],
                                        f32.pop("conv3x3_fwd_f32")["err"])
    res.update(f32)
    _timed("9", phase_f32_unets, k3, kattn, dev)
    f32_launches, f32_step_s = _timed("9", phase_f32_e2e, k3, kattn, dev,
                                      ROOT / "outputs" / "chip_smoke_f32", step_s)
    for name in ("conv3x3_dx_f32", "attn_fwd_f32", "attn_bwd_f32"):
        launches[name] = f32_launches[name]
    res["conv3x3_fwd_halo_f32"] = _timed("10", phase_halo_f32, k3, dev)
    _timed("10", phase_split_unet_f32, k3, dev)
    mesh_f32_launches, _ = _timed(
        "10", phase_f32_e2e, k3, kattn, dev, ROOT / "outputs" / "chip_smoke_f32_mesh",
        mesh_step_s, mesh=make_mesh([dev, dev]), f32_step_s=f32_step_s, say=_say10)
    launches["conv3x3_fwd_halo_f32"] = mesh_f32_launches["conv3x3_fwd_halo_f32"]
    _timed("10", phase_f32_mesh_cli, k3, kattn, dev, ROOT / "outputs" / "chip_smoke_f32_mesh_cli")
    _timed("12", phase_12, k3, kattn, dev, step_s, peak_256)
    _timed("13", phase_13, k3, kattn, dev)
    _timed("14", phase_14, k3, kattn, dev, step_s, peak_256)
    frames = sorted(f for f in (ROOT / "outputs" / "chip_smoke").rglob("*.png")
                    if "plain" not in f.relative_to(ROOT).parts)  # the kernels' run
    if not frames:
        raise AssertionError("phase 5 left no frame for phase 15c")
    _timed("15", phase_15, k3, kattn, dev, step_s, frames[-1])
    rows, augs_launches = _timed("16", phase_16, k3, kattn, dev)
    res.update(rows)
    for name in ("warp_index", "warp_bwd"):
        launches[name] = augs_launches[name]
    for way in ("fwd", "bwd"):  # phase 6's, all three modes
        launches[f"bn_act_{way}"] = sum(launches[f"bn_act_{way}_{m}"] for m in "abc")

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
        "warp_bwd": ("cgd_tpu_torch/csrc/warp_bwd.cu",
                     "cgd_tpu/guidance/cutouts.py:151 (map_coordinates' transpose, XLA; no "
                     "Pallas kernel)"),
        "warp_index": ("cgd_tpu_torch/csrc/warp_index.cu",
                       "cgd_tpu/guidance/cutouts.py:151 (the index of map_coordinates' "
                       "transpose, XLA; no Pallas kernel)"),
        "bn_act_fwd": ("cgd_tpu_torch/csrc/bn_act.cu",
                       "cgd_tpu/models/clip/model.py:154 and :189-201 (the folded BatchNorm, "
                       "residual add and ReLU, XLA; no Pallas kernel)"),
        "bn_act_bwd": ("cgd_tpu_torch/csrc/bn_act.cu",
                       "cgd_tpu/models/clip/model.py:154 and :189-201 (their transpose, XLA; no "
                       "Pallas kernel)"),
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
    for phase, seconds in PHASE_SECONDS.items():
        print(f"[11] phase {phase}: {seconds:.1f} s")
    print(f"[11] chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s, the kernels' "
          "build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
