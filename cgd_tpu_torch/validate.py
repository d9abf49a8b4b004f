"""Parameter validation — ``check_parameters`` copied from
``cgd_tpu/validate.py`` (pure Python), so that the port imports nothing of
the JAX package. Pinned to the original by tests/test_torch_port_api.py.

Raises ValueError for hard errors; prints warnings for soft ones, matching the
reference's mix of raises and warnings (reference: check_parameters,
cgd/script_util.py:24-57)."""

from __future__ import annotations

import os
from typing import List

from cgd_tpu_torch.registry import (
    CLIP_MODEL_NAMES,
    DIFFUSION_SCHEDULES,
    IMAGE_SIZES,
    TIMESTEP_RESPACINGS,
)

# save_frequency values at or above this mean "save only the final frame",
# on purpose — skip the exceeds-respacing warning for them.
FINAL_FRAME_ONLY = 10**9


def check_parameters(
    prompts: List[str],
    image_prompts: List[str],
    image_size: int,
    timestep_respacing: str,
    diffusion_steps: int,
    clip_model_name: str,
    save_frequency: int,
    noise_schedule: str,
) -> None:
    if not (len(prompts) > 0 or len(image_prompts) > 0):
        raise ValueError("Must provide at least one prompt, text or image.")
    if noise_schedule not in ("linear", "cosine"):
        raise ValueError("Noise schedule should be one of: linear, cosine")
    if image_size not in IMAGE_SIZES:
        raise ValueError(f"--image size should be one of {IMAGE_SIZES}")
    # Comma-separated section specs ("25,25,10") are valid respacings
    # (diffusion/respace.py:space_timesteps); total steps = sum of sections.
    sections = str(timestep_respacing).replace("ddim", "")
    try:
        respace_steps = sum(int(s) for s in sections.split(",") if s)
    except ValueError:
        raise ValueError(
            f"--timestep_respacing {timestep_respacing!r} is not a step count, "
            "'ddimN', or comma-separated section list"
        )
    if save_frequency <= 0:
        raise ValueError("--save_frequency must be greater than 0")
    if save_frequency < FINAL_FRAME_ONLY and save_frequency > respace_steps:
        # a large save_frequency legitimately means "save only first + final frame"
        print(
            f"(warning) --save_frequency {save_frequency} exceeds "
            f"timestep_respacing {respace_steps}; only the first and final "
            "frames will be saved"
        )
    if diffusion_steps not in DIFFUSION_SCHEDULES:
        print("(warning) Diffusion steps should be one of:", DIFFUSION_SCHEDULES)
    if timestep_respacing not in TIMESTEP_RESPACINGS:
        print(
            f"(warning) `timestep_respacing` is usually one of {TIMESTEP_RESPACINGS}; "
            f"got {timestep_respacing!r}"
        )
    if clip_model_name.endswith(".pt") or clip_model_name.endswith(".pth"):
        if not os.path.isfile(clip_model_name):
            raise AssertionError(f"{clip_model_name} does not exist")
        print(f"Loading custom model from {clip_model_name}")
    elif clip_model_name not in CLIP_MODEL_NAMES and clip_model_name != "ViT-L/14@336px":
        print(
            f"--clip model name should be one of: {CLIP_MODEL_NAMES} "
            "unless you are trying to use your own checkpoint."
        )


# printed with the CLIP model's name when the card runs out of memory
# during sampling, then the error is raised again (cgd_tpu/validate.py's
# advice, worded for the card's memory)
OOM_ADVICE = """GPU out of memory (torch.cuda.OutOfMemoryError).
Try lowering --image_size/-size, --batch_size/-bs, --num_cutouts/-cutn.
--clip_model/-clip can have a large impact on memory usage:
'RN50' uses the least, 'ViT-B/32' the second least and is good for its
memory/runtime tradeoff. Larger models (RN50x16, ViT-L/14) need more GPU memory."""
