"""Where the 256px guided step's time goes, in three nested parts on the
card: the UNet forward, the forward plus its input gradient, and the whole
guided step. Counterpart of the JAX package's ``tools/time_components.py``.

    python -m cgd_tpu_torch.tools.time_components              # 256px, the card
    CGD_TPU_DEBUG_TINY=1 python -m cgd_tpu_torch.tools.time_components --size 64 --device cpu --n 2

The parts, as the JAX tool builds them: the class-conditional UNet of
``--size`` with random weights in bf16 on x ~ N(0, 1), t = 500, y = 0;
(1) its forward; (2) the forward and ``autograd.grad`` of sum(out[..., :3]^2)
with respect to x; (3) the guided step of ``tools/bench.py`` (ViT-B/32,
``make_diffusion(1000, "linear", "ddim250")``, target
``RandomState(2).randn(1, embed_dim)``, ``GuidanceSettings()``, 16
cutouts, random class labels) at t = 125 with the reference's t = 249,
its output fed to the next call. The conv kernels are cast to bf16 once,
as the API and the bench do (the JAX tool casts them inside its jitted
scan). Each part: one warm call, then ``n`` calls timed on the host clock
between two synchronizes (a Python loop stands in for the JAX tool's
``lax.scan``), the minimum of three such runs, in ms per call.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict

import torch

from cgd_tpu_torch.api import resolve_device
from cgd_tpu_torch.ops.nn import cast_conv_params
from cgd_tpu_torch.tools import bench
from cgd_tpu_torch.weights import resolve_unet


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, n: int, label: str,
          dev: torch.device) -> float:
    """ms per call of x -> fn(x) chained ``n`` times, min of 3 runs after a
    warm call."""
    t0 = time.perf_counter()
    out = fn(x)
    float(out.float().sum())
    log(f"{label}: first call {time.perf_counter() - t0:.1f}s")
    times = []
    for _ in range(3):
        bench.sync(dev)
        t0 = time.perf_counter()
        out = x
        for _ in range(n):
            out = fn(out)
        bench.sync(dev)
        times.append((time.perf_counter() - t0) / n)
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: the output is not finite")
    log(f"{label}: {min(times) * 1e3:.2f} ms/iter (min of 3, n={n})")
    return min(times) * 1e3


def measure_components(size: int = 256, device="cuda", n: int = 10) -> Dict[str, float]:
    """The three parts' ms per call: ``fwd``, ``fwd_grad`` (forward and
    input gradient) and ``step`` (the whole guided step)."""
    dev = resolve_device(device)
    unet, _, _ = resolve_unet(size, True, "random", device=dev)
    cast_conv_params(unet, torch.bfloat16)
    x = torch.randn(1, size, size, 3, generator=torch.Generator(dev).manual_seed(0), device=dev)
    y = torch.zeros((1,), dtype=torch.long, device=dev)
    t = torch.full((1,), 500.0, device=dev)
    label = f"unet{size}"

    def fwd(x_):
        with torch.no_grad():
            out = unet(x_, t, y, compute_dtype=torch.bfloat16)
        return x_ + 0.0 * out[..., :3]

    def fwd_grad(x_):
        x_ = x_.detach().requires_grad_(True)
        with torch.enable_grad():
            out = unet(x_, t, y, compute_dtype=torch.bfloat16)
            (g,) = torch.autograd.grad(out[..., :3].float().square().sum(), x_)
        return x_.detach() + 1e-9 * g

    res = {"fwd": timed(fwd, x, n, f"{label} fwd", dev),
           "fwd_grad": timed(fwd_grad, x, n, f"{label} fwd+input-grad", dev)}
    del unet
    step, _, _, _ = bench.build(size, "ViT-B/32", "ddim250", 16, device=dev)
    gen = torch.Generator(dev).manual_seed(1)

    def guided(x_):
        return step(x_, 125, 249, y, gen)[0]

    res["step"] = timed(guided, x, n, f"guided step {size} cutn16", dev)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--n", type=int, default=10, help="calls per timed run")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    measure_components(args.size, args.device, args.n)


if __name__ == "__main__":
    main()
