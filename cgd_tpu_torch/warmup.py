"""Warming a process before it serves, counterpart of ``cgd_tpu/warmup.py``.

On the card the first generation of a process pays for what later ones
reuse: the kernels' build at first use (``kernels/_build.library()``: nvcc
on ``csrc/*.cu``, tens of seconds when its cache under ``build/`` is cold,
nothing when warm), the CUDA context and the cuBLAS / cuDNN handles, and the
first launch of every shape of the operating point. Warming runs the real
generator once per operating point with random weights, so the daemon's
first request (``python -m cgd_tpu_torch.serve --warmup``) starts with all
of that done. Random weights suffice: the launches depend on the shapes,
not on the values.

``parse_spec`` is a copy of the JAX package's (pinned to it by
tests/test_torch_port_serve.py).
"""

from __future__ import annotations

import sys
import tempfile
import time
from typing import Iterable, Tuple

Spec = Tuple[int, str, int]  # (size, respacing, cutn)


def parse_spec(spec: str) -> Spec:
    """SIZE:RESPACE[:CUTN] (cutn defaults to 16, the reference default)."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"bad warmup spec {spec!r}: expected SIZE:RESPACE[:CUTN]")
    return int(parts[0]), parts[1], int(parts[2]) if len(parts) == 3 else 16


def warm_operating_points(
    specs: Iterable[Spec],
    save_frequency,
    batch_size: int = 1,
    clip_model_name: str = "ViT-B/32",
    class_cond: bool = True,
    mesh=None,
    stall_pet=None,
    log=None,
    device: str = "cuda",
) -> None:
    """Run each operating point end to end with random weights, with the
    segmentation the deployment will use (CLI default 1, API default 25,
    serve.py FINAL_FRAME_ONLY)."""
    from cgd_tpu_torch.api import clip_guided_diffusion

    if log is None:
        def log(*a):
            print(*a, file=sys.stderr, flush=True)

    for size, respace, cutn in specs:
        t0 = time.time()
        log(f"warming {size}px {respace} cutn={cutn} batch={batch_size} "
            f"save_frequency={save_frequency} on {device} ...")
        with tempfile.TemporaryDirectory() as td:
            gen = clip_guided_diffusion(
                prompts=["cache warmup"],
                image_size=size,
                timestep_respacing=respace,
                num_cutouts=cutn,
                batch_size=batch_size,
                class_cond=class_cond,
                clip_model_name=clip_model_name,
                save_frequency=save_frequency,
                weights_mode="random",
                prefix_path=td,
                progress=False,
                mesh=mesh,
                stall_pet=stall_pet,
                device=device,
            )
            n = sum(1 for _ in gen)
        log(f"  warmed in {time.time() - t0:.1f}s ({n} frame yields)")
