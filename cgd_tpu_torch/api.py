"""Public API of the port: the ``clip_guided_diffusion`` generator.

Counterpart of ``cgd_tpu/api.py``: same keyword names, same generator
contract — yields ``(batch_idx, saved_frame_path)`` per saved frame — and the
same output tree. The slice ported so far: text prompts with weights,
class-conditional or unconditional ADM UNet (64-512px) with random weights,
any CLIP tower (ViT or ModifiedResNet), DDIM (``timestep_respacing="ddimN"``) or ancestral sampling, cutouts (fresh
or cached), the spherical / TV / range / saturation losses and the magnitude
clamp. Every other option raises rather than being ignored.

``device`` defaults to ``"cuda"``; with no card that is an error. The CPU is
used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import hashlib
import time
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from cgd_tpu_torch.diffusion.gaussian import make_diffusion
from cgd_tpu_torch.diffusion.sampler import SamplerConfig, sample_loop
from cgd_tpu_torch.guidance.cutouts import sample_cutout_coords
from cgd_tpu_torch.guidance.pipeline import (
    GuidanceSettings,
    make_guidance_builder,
    normalize_weights,
)
from cgd_tpu_torch.guidance.prompts import parse_prompt
from cgd_tpu_torch.io_utils.images import log_image
from cgd_tpu_torch.models.clip.model import encode_text
from cgd_tpu_torch.ops.nn import cast_conv_params
from cgd_tpu_torch.validate import check_parameters
from cgd_tpu_torch.weights import resolve_clip, resolve_unet


class _FallbackTokenizer:
    """Hash-based stand-in used ONLY with weights_mode='random' when the BPE
    merge table is unavailable (offline dev/bench). Deterministic ids.
    A copy of ``cgd_tpu.api._FallbackTokenizer``."""

    def __init__(self, vocab_size: int, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length

    def tokenize(self, texts, context_length: int = 77, truncate: bool = False):
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [
                int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 3) + 1
                for w in t.lower().split()[: context_length - 2]
            ]
            row = [self.vocab_size - 2] + ids + [self.vocab_size - 1]
            out[i, : len(row)] = row
        return out


def resolve_device(device) -> torch.device:
    """The run's device: CUDA unless the caller asks for the CPU. A CUDA
    request without a card raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: only cuda and cpu are supported")
    return dev


def _refuse(**unsupported) -> None:
    for name, (value, default) in unsupported.items():
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to cgd_tpu_torch yet "
                f"(only the default {default!r} is supported)")


def clip_guided_diffusion(
    image_size: int = 128,
    num_cutouts: int = 16,
    prompts: "list[str]" = (),
    image_prompts: "list[str]" = (),
    clip_guidance_scale: float = 1000,
    tv_scale: float = 150,
    range_scale: float = 50,
    sat_scale: float = 0,
    init_scale: float = 0,
    batch_size: int = 1,
    init_image: Optional[str] = None,
    class_cond: bool = True,
    cutout_power: float = 1.0,
    timestep_respacing: str = "1000",
    seed: int = 0,
    diffusion_steps: int = 1000,
    skip_timesteps: int = 0,
    clip_model_name: str = "ViT-B/32",
    randomize_class: bool = True,
    prefix_path=Path("./outputs"),
    save_frequency: int = 25,
    noise_schedule: str = "linear",
    device: str = "cuda",
    use_augs: bool = False,
    use_magnitude: bool = False,
    height_offset: int = 0,
    width_offset: int = 0,
    progress: bool = True,
    reduce_clip: bool = False,
    progressive_cutout: bool = False,
    cached_cutouts: bool = False,
    weights_mode: str = "auto",
    compute_dtype: str = "bfloat16",
    dpm_solver: bool = False,
    fast_guidance: bool = False,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    mesh=None,
    wandb_project: Optional[str] = None,
) -> Iterator[Tuple[int, str]]:
    dev = resolve_device(device)
    _refuse(
        image_prompts=(tuple(image_prompts), ()), init_image=(init_image, None),
        init_scale=(init_scale, 0), use_augs=(use_augs, False),
        dpm_solver=(dpm_solver, False), fast_guidance=(fast_guidance, False),
        checkpoint_path=(checkpoint_path, None), resume_from=(resume_from, None),
        mesh=(mesh, None), skip_timesteps=(skip_timesteps, 0),
        reduce_clip=(reduce_clip, False), progressive_cutout=(progressive_cutout, False),
        height_offset=(height_offset, 0), width_offset=(width_offset, 0),
        wandb_project=(wandb_project, None),
    )
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got {compute_dtype!r}")
    if dev.type == "cuda" and compute_dtype != "bfloat16":
        raise ValueError("compute_dtype='float32' on CUDA: the conv kernels take bfloat16")

    prompts = list(prompts)
    check_parameters(
        prompts=prompts, image_prompts=[], image_size=image_size,
        timestep_respacing=timestep_respacing, diffusion_steps=diffusion_steps,
        clip_model_name=clip_model_name, save_frequency=save_frequency,
        noise_schedule=noise_schedule,
    )

    def say(msg):
        if progress:
            print(msg, flush=True)

    if not use_magnitude and image_size == 64:
        use_magnitude = True
        say("Enabling magnitude for 64x64 checkpoints.")
    Path(prefix_path).mkdir(parents=True, exist_ok=True)
    cdtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32

    # ---- models -------------------------------------------------------
    clip_model, clip_cfg = resolve_clip(clip_model_name, weights_mode, dev)
    unet, unet_cfg, flags = resolve_unet(
        image_size, class_cond, weights_mode,
        flag_overrides={"diffusion_steps": diffusion_steps, "noise_schedule": noise_schedule},
        device=dev,
    )
    if cdtype == torch.bfloat16:
        cast_conv_params(unet, cdtype)
        cast_conv_params(clip_model, cdtype)
    tokenizer = _FallbackTokenizer(clip_cfg.text.vocab_size)

    # ---- prompt encoding ----------------------------------------------
    parsed = [parse_prompt(p) for p in prompts]
    tokens = tokenizer.tokenize([t for t, _ in parsed],
                                context_length=clip_cfg.text.context_length)
    with torch.no_grad():
        target_embeds = encode_text(clip_model, torch.as_tensor(tokens, device=dev))
    weights = torch.as_tensor(normalize_weights([w for _, w in parsed]), device=dev)

    # ---- diffusion, guidance, sampler ---------------------------------
    diffusion = make_diffusion(
        steps=flags.get("diffusion_steps", 1000),
        noise_schedule=flags.get("noise_schedule", "linear"),
        timestep_respacing=timestep_respacing,
        rescale_timesteps=flags.get("rescale_timesteps", False),
        learn_sigma=flags.get("learn_sigma", True),
    )
    gen = torch.Generator(dev).manual_seed(seed)
    cached_coords = None
    if cached_cutouts:
        cached_coords = sample_cutout_coords(
            gen, num_cutouts, image_size, image_size, clip_cfg.input_resolution, cutout_power)
    settings = GuidanceSettings(
        clip_guidance_scale=clip_guidance_scale, tv_scale=tv_scale,
        range_scale=range_scale, sat_scale=sat_scale, use_magnitude=use_magnitude,
        cutout_power=cutout_power, clip_compute_dtype=compute_dtype,
    )
    builder = make_guidance_builder(
        clip_model, clip_cfg, target_embeds, weights, diffusion, settings,
        cached_coords=cached_coords)
    sampler_cfg = SamplerConfig(
        use_ddim=timestep_respacing.startswith("ddim"),
        randomize_class=(randomize_class and class_cond),
        num_classes=1000,
    )

    def model_fn(x, t_model, y):
        return unet(x, t_model, y, compute_dtype=cdtype)

    y_init = torch.zeros((batch_size,), dtype=torch.long, device=dev) if class_cond else None
    shape = (batch_size, image_size, image_size, 3)
    say(f"Sampling {diffusion.num_timesteps} steps at {image_size}px on {dev}")
    t0 = time.perf_counter()
    for step_k, pred_x0, _x_t in sample_loop(
        diffusion, model_fn, builder, shape, gen, sampler_cfg,
        num_cutouts=num_cutouts, save_frequency=save_frequency, y_init=y_init,
        final_frame_parity=True,
    ):
        frames = pred_x0.float().cpu().numpy()
        for batch_idx in range(batch_size):
            yield batch_idx, log_image(frames[batch_idx], prefix_path, prompts, step_k, batch_idx)
    say(f"Sampled in {time.perf_counter() - t0:.1f} s")
