"""Weight resolution for the port: random weights only, counterpart of
``cgd_tpu/weights.py``'s ``mode="random"``. The model configurations come from
the port's copy of the registry; loading the published checkpoints is not
ported yet.

``CGD_TPU_DEBUG_TINY=1`` swaps in the JAX package's toy-size UNet and CLIP
(the same escape hatch as ``cgd_tpu.weights``: every CLIP tower, ModifiedResNet
included, becomes a tiny ViT), for CPU smoke runs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS, CLIPConfig, TextConfig, VisionViTConfig
from cgd_tpu_torch.models.clip.model import CLIP
from cgd_tpu_torch.models.unet import UNet, UNetConfig
from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

_WEIGHTS_SEED = 0  # random weights are fixed, as cgd_tpu's PRNGKey(0) init


def _check_mode(mode: str) -> None:
    if mode != "random":
        raise NotImplementedError(
            f"weights_mode={mode!r}: checkpoint loading is not ported to "
            "cgd_tpu_torch yet; use weights_mode='random'")


def resolve_unet(
    image_size: int,
    class_cond: bool,
    mode: str = "random",
    flag_overrides: Optional[dict] = None,
    device="cuda",
) -> Tuple[UNet, UNetConfig, dict]:
    """Returns (unet, cfg, merged_flags), the flags merged as the reference
    does: registry defaults <- user overrides."""
    _check_mode(mode)
    info = DIFFUSION_LOOKUP["cond" if class_cond else "uncond"][image_size]
    flags = dict(info["model_flags"])
    if flag_overrides:
        flags.update({k: v for k, v in flag_overrides.items() if v is not None})
    cfg = UNetConfig.from_flags(flags)
    if os.environ.get("CGD_TPU_DEBUG_TINY"):
        cfg = dataclasses.replace(
            cfg, model_channels=32, num_res_blocks=1,
            channel_mult=(1, 2), attention_ds=(2,), num_head_channels=16,
            num_heads=1,
        )
    gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
    return UNet(cfg, device=device).init_weights(gen), cfg, flags


def resolve_clip(model_name: str, mode: str = "random", device="cuda") -> Tuple[CLIP, CLIPConfig]:
    """Any of the registry's CLIP models, ViT or ModifiedResNet, random."""
    _check_mode(mode)
    cfg = CLIP_CONFIGS.get(model_name)
    if cfg is None:
        raise ValueError(f"Unknown CLIP model {model_name!r}; known: {sorted(CLIP_CONFIGS)}")
    if os.environ.get("CGD_TPU_DEBUG_TINY"):
        cfg = dataclasses.replace(
            cfg,
            vision=VisionViTConfig(cfg.input_resolution, 32, 64, 2, 2),
            text=TextConfig(width=64, heads=2, layers=2),
            embed_dim=64,
        )
    gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
    return CLIP(cfg, device=device).init_weights(gen), cfg
