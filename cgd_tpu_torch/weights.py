"""Weight resolution for the port, counterpart of ``cgd_tpu/weights.py``:
converted cache -> torch convert -> download, or random weights.

``mode="auto"`` reads the published checkpoints in the reference's cache
layout (``checkpoints_dir``, by default ~/.cache/clip-guided-diffusion, CLIP
under ``clip/``) as the original torch ``.pt`` files, and stores a converted
flat npz next to each on first use (``<name>.pt`` -> ``<name>.pt.npz.cgd``),
the JAX package's cache format (``utils/pytree_io.py``): a cache written by
either package loads in the other. A missing ``.pt`` is downloaded. The
weights are built on the host and moved to the run's device once. A CLIP
model name ending in ``.pt`` / ``.pth`` is a local checkpoint whose
configuration is read from its shapes (``convert/clip_config_infer.py``),
in either mode, as in the JAX package.

``mode="random"`` gives randomly initialised weights from a fixed seed, for
runs without checkpoints; there ``CGD_TPU_DEBUG_TINY=1`` swaps in the JAX
package's toy-size UNet and CLIP (every CLIP tower, ModifiedResNet
included, becomes a tiny ViT), for CPU smoke runs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cgd_tpu_torch.convert.from_jax import load_flat
from cgd_tpu_torch.io_utils.download import CACHE_PATH, download
from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS, CLIPConfig, TextConfig, VisionViTConfig
from cgd_tpu_torch.models.clip.model import CLIP
from cgd_tpu_torch.models.unet import UNet, UNetConfig
from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS
from cgd_tpu_torch.registry import CLIP_MODEL_URLS, DIFFUSION_LOOKUP
from cgd_tpu_torch.utils import pytree_io

_WEIGHTS_SEED = 0  # random weights are fixed, as cgd_tpu's PRNGKey(0) init


def _converted_path(pt_path: str) -> str:
    return pt_path + ".npz.cgd"


def _cached(npz_path: str, convert) -> Dict[str, np.ndarray]:
    """The flat parameters from the converted cache, or ``convert()``'s,
    written to the cache first."""
    if os.path.exists(npz_path):
        return pytree_io.load_flat(npz_path)
    flat = convert()
    pytree_io.save_flat(npz_path, flat)
    return flat


def _on_device(module: torch.nn.Module, flat: Dict[str, np.ndarray], device) -> torch.nn.Module:
    """``module`` (built on the host) loaded from ``flat``, then moved to
    ``device`` in one go."""
    return load_flat(module, flat).to(device)


def resolve_unet(
    image_size: int,
    class_cond: bool,
    mode: str = "random",
    flag_overrides: Optional[dict] = None,
    device="cuda",
    checkpoints_dir: str = CACHE_PATH,
) -> Tuple[UNet, UNetConfig, dict]:
    """Returns (unet, cfg, merged_flags), the flags merged as the reference
    does: registry defaults <- user overrides."""
    info = DIFFUSION_LOOKUP["cond" if class_cond else "uncond"][image_size]
    flags = dict(info["model_flags"])
    if flag_overrides:
        flags.update({k: v for k, v in flag_overrides.items() if v is not None})
    cfg = UNetConfig.from_flags(flags)
    if mode == "random":
        if os.environ.get("CGD_TPU_DEBUG_TINY"):
            cfg = dataclasses.replace(
                cfg, model_channels=32, num_res_blocks=1,
                channel_mult=(1, 2), attention_ds=(2,), num_head_channels=16,
                num_heads=1,
            )
        gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
        return UNet(cfg, device=device).init_weights(gen), cfg, flags

    pt_path = os.path.join(checkpoints_dir, info["filename"])

    def convert():
        if not os.path.exists(pt_path):
            download(info["url"], info["filename"], checkpoints_dir)
        from cgd_tpu_torch.convert.torch_unet import convert_unet_checkpoint

        return convert_unet_checkpoint(pt_path, cfg)

    flat = _cached(_converted_path(pt_path), convert)
    return _on_device(UNet(cfg, device="cpu"), flat, device), cfg, flags


def resolve_clip(model_name: str, mode: str = "random", device="cuda",
                 checkpoints_dir: str = CACHE_PATH) -> Tuple[CLIP, CLIPConfig]:
    """Any of the registry's CLIP models, ViT or ModifiedResNet, or a local
    ``.pt`` / ``.pth`` checkpoint."""
    if model_name.endswith((".pt", ".pth")):
        return _resolve_custom_clip(model_name, device)
    cfg = CLIP_CONFIGS.get(model_name)
    if cfg is None:
        raise ValueError(
            f"Unknown CLIP model {model_name!r}; known: {sorted(CLIP_CONFIGS)} "
            "or a local .pt/.pth checkpoint path")
    if mode == "random":
        if os.environ.get("CGD_TPU_DEBUG_TINY"):
            cfg = dataclasses.replace(
                cfg,
                vision=VisionViTConfig(cfg.input_resolution, 32, 64, 2, 2),
                text=TextConfig(width=64, heads=2, layers=2),
                embed_dim=64,
            )
        gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
        return CLIP(cfg, device=device).init_weights(gen), cfg

    clip_dir = os.path.join(checkpoints_dir, "clip")
    filename = model_name.replace("/", "-") + ".pt"
    pt_path = os.path.join(clip_dir, filename)

    def convert():
        if not os.path.exists(pt_path):
            download(CLIP_MODEL_URLS[model_name], filename, clip_dir)
        from cgd_tpu_torch.convert.torch_clip import convert_clip_checkpoint

        return convert_clip_checkpoint(pt_path, cfg)

    flat = _cached(_converted_path(pt_path), convert)
    return _on_device(CLIP(cfg, device="cpu"), flat, device), cfg


def _resolve_custom_clip(pt_path: str, device) -> Tuple[CLIP, CLIPConfig]:
    if not os.path.exists(pt_path):
        raise FileNotFoundError(pt_path)
    from cgd_tpu_torch.convert.clip_config_infer import infer_clip_config
    from cgd_tpu_torch.convert.torch_clip import convert_state_dict, load_torch_clip_sd

    sd = load_torch_clip_sd(pt_path)
    cfg = infer_clip_config(sd, name=os.path.basename(pt_path))
    flat = _cached(_converted_path(pt_path), lambda: convert_state_dict(sd, cfg))
    return _on_device(CLIP(cfg, device="cpu"), flat, device), cfg


def resolve_lpips(mode: str = "random", device="cuda",
                  checkpoints_dir: str = CACHE_PATH) -> VGGLPIPS:
    """The LPIPS VGG16 weights: random, or torchvision's VGG16 and lpips'
    heads (the two ``.pth`` files looked up in, and downloaded to, the
    reference's cache) converted once into ``checkpoints_dir``'s
    ``lpips_vgg.npz.cgd``."""
    if mode == "random":
        gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
        return VGGLPIPS(device=device).init_weights(gen)
    from cgd_tpu_torch.convert.torch_lpips import convert_lpips

    flat = _cached(os.path.join(checkpoints_dir, "lpips_vgg.npz.cgd"), convert_lpips)
    return _on_device(VGGLPIPS(device="cpu"), flat, device)
