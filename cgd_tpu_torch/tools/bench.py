"""Headline measurement of the port: wall seconds per image of a CLIP-guided
sample on the card, the FLOPs of one guided step, and their share of the
card's bf16 peak. Counterpart of the JAX package's ``bench.py``.

    python -m cgd_tpu_torch.tools.bench                      # 256px ddim250, 16 cutouts, ViT-B/32
    python -m cgd_tpu_torch.tools.bench --respace ddim25     # the smoke run's point
    python -m cgd_tpu_torch.tools.bench --respace ddim50 --dpm
    python -m cgd_tpu_torch.tools.bench --fast               # no UNet backward
    python -m cgd_tpu_torch.tools.bench --size 512 --clip RN50x16
    CGD_TPU_DEBUG_TINY=1 python -m cgd_tpu_torch.tools.bench --size 64 --respace ddim5 --cutn 2 --device cpu

The step is built as the JAX bench builds it: the class-conditional ADM UNet
of ``--size`` and ``--clip``'s CLIP with random weights, their conv kernels
cast to bf16 once (``cast_conv_params``), the UNet in bf16, one random
target embedding (``RandomState(2)``) at weight 1, ``GuidanceSettings()``
(CLIP in bf16), ``--cutn`` cutouts, random class labels, DDIM (or the
ancestral update, or ``--dpm``'s DPM-Solver++(2M) with its state carried
from step to step). S steps run from t = S-1 down to 0 from x0 ~ N(0, 1)
(a seeded ``torch.Generator``) and y0 = 0: one warm run, then the minimum
of three timed runs, each closed by a synchronize; the figure per image is
that minimum over ``--batch``. ``--stall-timeout`` arms
``utils/watchdog.StallDetector`` (exit 117 with every thread's stack when
no phase completes for that long), disarmed in a ``finally``.

Prints one JSON line last: ``metric`` (the JAX bench's name,
``{size}px_{respace}[_dpm]_guided_wallclock_per_image``), ``value`` (s),
``unit``, ``device`` (the card's name, or ``cpu``), ``flops_per_step`` and,
on a card whose bf16 dense peak is known (``BF16_PEAK``), ``mfu`` = FLOPs
of the S steps / wall time / peak. It differs from the JAX record where the
JAX one is tied to a TPU: no ``vs_baseline`` (its 15 s target is for a
TPU v5e chip, not this card), no on-device re-validation of a TPU conv
allowlist, and ``flops_per_step`` counted from the models' shapes
(``guided_step_flops``: the matmuls, convolutions and attention products
of one step, input gradients only) where the JAX bench asks XLA's cost
analysis, which also counts elementwise work. The count is made once from
the configuration, never on the timed path (the kernels are ctypes
launches that no FLOP counter sees).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from cgd_tpu_torch.api import resolve_device
from cgd_tpu_torch.diffusion.gaussian import make_diffusion
from cgd_tpu_torch.diffusion.sampler import SamplerConfig, StepMeta, make_guided_step
from cgd_tpu_torch.guidance.pipeline import GuidanceSettings, make_guidance_builder
from cgd_tpu_torch.models.clip.configs import CLIPConfig
from cgd_tpu_torch.models.unet import UNetConfig, block_plan
from cgd_tpu_torch.ops.nn import cast_conv_params
from cgd_tpu_torch.utils.watchdog import StallDetector
from cgd_tpu_torch.weights import resolve_clip, resolve_unet

# dense bf16 tensor-core peaks (NVIDIA's data sheets, at the card's full
# power limit), matched in order against torch.cuda.get_device_name
BF16_PEAK = (("H100 PCIe", 756e12), ("H100", 989e12), ("H200", 989e12))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bf16_peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in FLOP/s, None for a card not listed."""
    for key, peak in BF16_PEAK:
        if key in device_name:
            return peak
    return None


# ---------------------------------------------------------------------------
# FLOPs of one guided step, from the models' shapes
# ---------------------------------------------------------------------------

class _Flops:
    """FLOPs by the aten op family ``torch.utils.flop_counter`` files them
    under (``matmul``: mm / bmm / addmm / baddbmm; ``convolution`` and
    ``convolution_backward``), forward and input-gradient work added as a
    step does it."""

    def __init__(self):
        self.by_op = {"matmul": 0, "convolution": 0, "convolution_backward": 0}

    def matmul(self, m: int, k: int, n: int, grads: int = 1, count: int = 1) -> None:
        """``count`` products [m, k] @ [k, n], and in the backward one
        product of the same size for each of ``grads`` operands that depend
        on x (0: forward only)."""
        self.by_op["matmul"] += 2 * m * k * n * count * (1 + grads)

    def conv(self, n: int, hw: int, kk: int, cin: int, cout: int, grad: bool) -> None:
        """A conv over n images to hw output pixels with kk taps; its input
        gradient (the same product count) where ``grad``."""
        f = 2 * n * hw * kk * cin * cout
        self.by_op["convolution"] += f
        if grad:
            self.by_op["convolution_backward"] += f

    @property
    def total(self) -> int:
        return sum(self.by_op.values())


def _unet_flops(acc: _Flops, cfg: UNetConfig, size: int, batch: int, grad: bool) -> None:
    """The UNet forward at size x size (and its input gradient where
    ``grad``) as the plain routing runs it: every 3x3 conv, the 1x1 skips
    and the dense layers as matmuls, and the attention's two products per
    head. The timestep / class embedding path does not depend on x."""
    g = int(grad)
    b, mc, temb = batch, cfg.model_channels, cfg.time_embed_dim
    acc.matmul(b, mc, temb, grads=0)
    acc.matmul(b, temb, temb, grads=0)
    input_plan, middle_plan, output_plan, out_ch = block_plan(cfg)
    ch0 = int(cfg.channel_mult[0] * mc)
    acc.conv(b, size * size, 9, cfg.in_channels, ch0, grad)
    res = size
    for spec in [s for blk in input_plan for s in blk] + list(middle_plan) + [
            s for blk in output_plan for s in blk]:
        kind = spec[0]
        if kind == "res":
            _, cin, cout, mode = spec
            res = res // 2 if mode == "down" else res * 2 if mode == "up" else res
            hw = res * res
            acc.conv(b, hw, 9, cin, cout, grad)
            acc.matmul(b, temb, 2 * cout if cfg.use_scale_shift_norm else cout, grads=0)
            if cin != cout:
                acc.matmul(b * hw, cin, cout, grads=g)
            acc.conv(b, hw, 9, cout, cout, grad)
        elif kind == "attn":
            ch, t = spec[1], res * res
            heads = cfg.heads_for(ch)
            acc.matmul(b * t, ch, 3 * ch, grads=g)
            acc.matmul(t, ch // heads, t, grads=2 * g, count=b * heads)  # q k^T
            acc.matmul(t, t, ch // heads, grads=2 * g, count=b * heads)  # P v
            acc.matmul(b * t, ch, ch, grads=g)
        else:  # downsample / upsample convs (resblock_updown=False)
            res = res // 2 if kind == "downsample" else res * 2
            acc.conv(b, res * res, 9, spec[1], spec[1], grad)
    acc.conv(b, size * size, 9, out_ch, cfg.out_channels, grad)


def _block_flops(acc: _Flops, n: int, t: int, w: int, heads: int) -> None:
    """One transformer block over n sequences of t tokens, width w."""
    acc.matmul(n * t, w, 3 * w)
    acc.matmul(t, w // heads, t, grads=2, count=n * heads)
    acc.matmul(t, t, w // heads, grads=2, count=n * heads)
    acc.matmul(n * t, w, w)
    acc.matmul(n * t, w, 4 * w)
    acc.matmul(n * t, 4 * w, w)


def _clip_image_flops(acc: _Flops, cfg: CLIPConfig, n: int) -> None:
    """The image tower over n images and its input gradient."""
    v, r = cfg.vision, cfg.input_resolution
    if cfg.is_vit:
        grid = (r // v.patch_size) ** 2
        acc.matmul(n * grid, v.patch_size ** 2 * 3, v.width)
        for _ in range(v.layers):
            _block_flops(acc, n, grid + 1, v.width, v.heads)
        acc.matmul(n, v.width, cfg.embed_dim)
        return
    w = v.width
    res = r // 2
    for cin, cout in ((3, w // 2), (w // 2, w // 2), (w // 2, w)):  # the stem, stride 2 first
        acc.conv(n, res * res, 9, cin, cout, True)
    res //= 2
    cin = w
    for blocks, planes, stride in zip(v.layers, (w, 2 * w, 4 * w, 8 * w), (1, 2, 2, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            out_res = res // s
            acc.conv(n, res * res, 1, cin, planes, True)
            acc.conv(n, res * res, 9, planes, planes, True)
            acc.conv(n, out_res * out_res, 1, planes, 4 * planes, True)
            if s > 1 or cin != 4 * planes:
                acc.conv(n, out_res * out_res, 1, cin, 4 * planes, True)
            cin, res = 4 * planes, out_res
    c, t = 32 * w, res * res + 1
    acc.matmul(n, c, c)  # q of the mean token
    acc.matmul(n * t, c, c, count=2)  # k, v
    acc.matmul(1, c // v.heads, t, grads=2, count=n * v.heads)
    acc.matmul(1, t, c // v.heads, grads=2, count=n * v.heads)
    acc.matmul(n, c, cfg.embed_dim)


def guided_step_flops(unet_cfg: UNetConfig, clip_cfg: CLIPConfig, size: int, batch: int,
                      cutn: int, fast: bool, breakdown: bool = False):
    """FLOPs of one guided step at size x size, ``batch`` images and
    ``cutn`` cutouts each: the UNet forward, its input gradient (absent
    under ``fast`` guidance), the cutouts' two box-filter products per
    image and the CLIP image tower over cutn x batch cutouts, each with its
    input gradient. Counted as ``torch.utils.flop_counter`` counts the
    plain routing (2 per multiply-add of every matmul, convolution and
    attention product; no weight gradients, no elementwise work), which the
    tests hold it to. ``breakdown``: also the dict by op family."""
    acc = _Flops()
    _unet_flops(acc, unet_cfg, size, batch, grad=not fast)
    cut = clip_cfg.input_resolution
    # make_cutouts: einsum over H (cutn*cut rows) then over W, 3 channels
    acc.matmul(cutn * cut, size, batch * size * 3)
    acc.matmul(cut, size, batch * cut * 3, count=cutn)
    _clip_image_flops(acc, clip_cfg, cutn * batch)
    return (acc.total, dict(acc.by_op)) if breakdown else acc.total


# ---------------------------------------------------------------------------
# the step and its loop
# ---------------------------------------------------------------------------

def make_step(unet, clip, clip_cfg: CLIPConfig, diffusion, cutn: int, use_ddim: bool = True,
              fast: bool = False, dpm: bool = False, dtype=torch.bfloat16,
              randomize_class: bool = True, cached_coords=None):
    """The bench's guided step (``make_guided_step``'s contract): DDIM or
    the ancestral update (``use_ddim``), or DPM-Solver++(2M); the UNet in
    ``dtype``, one target embedding from ``RandomState(2)`` at weight 1,
    ``GuidanceSettings()`` with CLIP in ``dtype``, ``cutn`` cutouts (drawn
    each step, or ``cached_coords``)."""
    dev = next(unet.parameters()).device
    target = np.random.RandomState(2).randn(1, clip_cfg.embed_dim).astype(np.float32)
    settings = GuidanceSettings(
        clip_compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    builder = make_guidance_builder(
        clip, clip_cfg, torch.from_numpy(target).to(dev), torch.ones(1, device=dev), diffusion,
        settings, cached_coords=cached_coords)

    def model_fn(x, t_model, y):
        return unet(x, t_model, y, compute_dtype=dtype)

    return make_guided_step(
        diffusion, model_fn, builder(StepMeta(t=0, guided=True, cutn=cutn)),
        SamplerConfig(use_ddim=use_ddim, randomize_class=randomize_class,
                      fast_guidance=fast, dpm_solver=dpm))


def build(size: int = 256, clip_name: str = "ViT-B/32", respace: str = "ddim250", cutn: int = 16,
          fast: bool = False, dpm: bool = False, device="cuda"):
    """The bench's models and step on ``device`` (random weights, conv
    kernels cast to bf16): (step, unet_cfg, clip_cfg, number of steps)."""
    dev = resolve_device(device)
    clip, clip_cfg = resolve_clip(clip_name, "random", dev)
    unet, unet_cfg, flags = resolve_unet(size, True, "random", device=dev)
    cast_conv_params(clip, torch.bfloat16)
    cast_conv_params(unet, torch.bfloat16)
    diffusion = make_diffusion(1000, flags.get("noise_schedule", "linear"), respace,
                               rescale_timesteps=flags.get("rescale_timesteps", False))
    step = make_step(unet, clip, clip_cfg, diffusion, cutn, respace.startswith("ddim"), fast, dpm)
    return step, unet_cfg, clip_cfg, diffusion.num_timesteps


def run_steps(step, x0: torch.Tensor, y0: torch.Tensor, steps: int, dpm: bool,
              gen: torch.Generator) -> torch.Tensor:
    """``steps`` guided steps from t = steps-1 down to 0 (ref_t = t), the
    DPM state carried under ``dpm`` (the previous step's t, zeros and
    ``first`` before the first step). Returns the last x."""
    x, y = x0, y0
    x0p = torch.zeros_like(x0) if dpm else None
    for i in range(steps):
        t = steps - 1 - i
        if dpm:
            x, _, y, _, x0p = step(x, t, t, y, gen, dpm_state=(x0p, t if i == 0 else t + 1, i == 0))
        else:
            x, _, y, _ = step(x, t, t, y, gen)
    return x


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench(args, dog: StallDetector) -> Dict[str, float]:
    """The timed runs: {per_image, steps, seconds (min of 3), flops_per_step}."""
    dev = resolve_device(args.device)
    dog.pet("resolve weights + build step")
    step, unet_cfg, clip_cfg, steps = build(args.size, args.clip, args.respace, args.cutn,
                                            args.fast, args.dpm, dev)
    shape = (args.batch, args.size, args.size, 3)
    x0 = torch.randn(shape, generator=torch.Generator(dev).manual_seed(0), device=dev)
    y0 = torch.zeros((args.batch,), dtype=torch.long, device=dev)

    log(f"{args.size}px {args.respace} guided loop (cutn={args.cutn}) on {dev}: warm run")
    dog.pet("warm run")
    t0 = time.perf_counter()
    out = run_steps(step, x0, y0, steps, args.dpm, torch.Generator(dev).manual_seed(1))
    warm = float(out.mean())
    log(f"first run (kernels' build included): {time.perf_counter() - t0:.1f}s (mean={warm:.4f})")
    times = []
    for i in range(3):
        dog.pet(f"timed run {i}")
        sync(dev)
        t0 = time.perf_counter()
        out = run_steps(step, x0, y0, steps, args.dpm, torch.Generator(dev).manual_seed(2 + i))
        sync(dev)
        times.append(time.perf_counter() - t0)
        log(f"run {i}: {times[-1]:.2f}s")
    if not torch.isfinite(out).all():
        raise RuntimeError("bench: the sample is not finite")
    dt = min(times)
    flops = guided_step_flops(unet_cfg, clip_cfg, args.size, args.batch, args.cutn, args.fast)
    return {"per_image": dt / args.batch, "steps": steps, "seconds": dt,
            "flops_per_step": flops}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--respace", default="ddim250")
    ap.add_argument("--cutn", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--clip", default="ViT-B/32")
    ap.add_argument("--fast", action="store_true",
                    help="fast guidance (detached pred_xstart, no UNet backward; NOT the "
                         "reference's semantics)")
    ap.add_argument("--dpm", action="store_true",
                    help="the DPM-Solver++(2M) update (second order: pair it with a small "
                         "--respace budget such as ddim50; NOT the reference's semantics)")
    ap.add_argument("--stall-timeout", type=float, default=1200.0, metavar="SECONDS",
                    help="exit 117 with every thread's stack if no phase completes for this "
                         "long (a hung card call blocks forever otherwise); it must exceed the "
                         "kernels' first build inside the warm run. 0 disables")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dog = StallDetector(args.stall_timeout, exit_on_stall=True)
    dog.__enter__()
    try:
        res = bench(args, dog)
    finally:
        dog.__exit__(None, None, None)  # timing done; the JSON line is not watched
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    steps, dt, flops = res["steps"], res["seconds"], res["flops_per_step"]
    log(f"steady state (min of 3): {dt:.2f}s total, {steps / dt:.2f} guided steps/s, "
        f"{res['per_image']:.3f}s/image")
    tag = "_dpm" if args.dpm else ""
    record = {
        "metric": f"{args.size}px_{args.respace}{tag}_guided_wallclock_per_image",
        "value": res["per_image"],
        "unit": "seconds",
        "device": name,
        "flops_per_step": flops,
    }
    peak = bf16_peak_flops(name) if dev.type == "cuda" else None
    if peak is not None:
        record["mfu"] = flops * steps / dt / peak
        log(f"MFU: {record['mfu']:.4f} ({flops * steps / dt / 1e12:.1f} TFLOP/s achieved vs "
            f"{peak / 1e12:.0f} TFLOP/s bf16 peak of {name})")
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
