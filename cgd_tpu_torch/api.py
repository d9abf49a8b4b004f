"""Public API of the port: the ``clip_guided_diffusion`` generator.

Counterpart of ``cgd_tpu/api.py``: same keyword names, same generator
contract — yields ``(batch_idx, saved_frame_path)`` per saved frame — and the
same output tree. The slice ported so far: text prompts with weights and
image prompts, class-conditional or unconditional ADM UNet (64-512px) with
the published checkpoints (``weights_mode="auto"``: the reference's
``.pt`` files in ``checkpoints_dir``, converted once to the JAX package's
``.npz.cgd`` cache) or random weights, any CLIP tower (ViT or
ModifiedResNet, or a local ``.pt``), the CLIP BPE tokenizer, DDIM
(``timestep_respacing="ddimN"``) or ancestral sampling, an init image with
``skip_timesteps`` and the LPIPS VGG loss (``init_scale``), cutouts (fresh
or cached), the spherical / TV / range / saturation losses, the magnitude
clamp, ``strict_parity`` either way, and ``mesh=``
(``cgd_tpu_torch.parallel.mesh``): batch split over 'data', the UNet's
activations split by height over 'cut' (every 3x3 conv on K-halo), the
cutouts split over every mesh device. Every other option raises rather
than being ignored.

The signature is ``cgd_tpu.api.clip_guided_diffusion``'s, keyword for keyword
and default for default (tests/test_torch_port_api.py pins it), except
``device``: it defaults to ``"cuda"``, and with no card that is an error. The
CPU is used only when the caller passes ``device="cpu"``. ``dropout`` is
taken and, as in the JAX package's sampling, never applied.
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
from cgd_tpu_torch.guidance.cutouts import CutoutSpec, make_cutouts, sample_cutout_coords
from cgd_tpu_torch.guidance.pipeline import (
    GuidanceSettings,
    make_guidance_builder,
    normalize_weights,
)
from cgd_tpu_torch.guidance.prompts import parse_prompt
from cgd_tpu_torch.io_utils.images import decode_image, load_image_rgb, log_image
from cgd_tpu_torch.models.clip.configs import CLIP_MEAN, CLIP_STD, CLIPConfig
from cgd_tpu_torch.models.clip.model import CLIP, encode_image, encode_text
from cgd_tpu_torch.ops.nn import cast_conv_params
from cgd_tpu_torch.ops.resample import resize
from cgd_tpu_torch.parallel.mesh import shard_params_replicated, split_activation
from cgd_tpu_torch.validate import check_parameters
from cgd_tpu_torch.weights import CACHE_PATH, resolve_clip, resolve_lpips, resolve_unet


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


def _prompt_image(img_path: str, image_size: int, device) -> torch.Tensor:
    """An image prompt as [h, w, 3] f32 in [0, 1] on ``device``: decoded,
    then lanczos3-resized so that its FIRST dim is min(image_size, W, H) and
    the second kept (the reference's ResizeRight partial-shape behaviour,
    ``cgd_tpu/api.py:109-130``)."""
    rgb = decode_image(img_path)
    arr = torch.from_numpy(np.asarray(rgb, dtype=np.float32) / 255.0).to(device)
    smallest = min(image_size, rgb.shape[1], rgb.shape[0])
    return resize(arr, (smallest,))


@torch.no_grad()
def encode_image_prompt(clip_model: CLIP, clip_cfg: CLIPConfig, img: torch.Tensor,
                        spec: CutoutSpec, strict_parity: bool = True) -> torch.Tensor:
    """The prompt image's cutouts ([h, w, 3] in [0, 1], cut at ``spec``) ->
    CLIP embeddings [K, D] (f32). ``strict_parity`` normalizes each pixel's
    channels to unit L2 norm, as the reference does
    (``torch.nn.functional.normalize``, cgd/clip_util.py:100); otherwise
    the cutouts get CLIP's mean / std, as in the guidance loop."""
    cuts = make_cutouts(img[None], spec, clip_cfg.input_resolution)
    if strict_parity:
        cuts = cuts / cuts.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-12)
    else:
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=cuts.device)
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=cuts.device)
        cuts = (cuts - mean) / std
    return encode_image(clip_model, cuts)


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
    checkpoints_dir: str = CACHE_PATH,
    clip_model_name: str = "ViT-B/32",
    randomize_class: bool = True,
    prefix_path=Path("./outputs"),
    save_frequency: int = 25,
    noise_schedule: str = "linear",
    dropout: float = 0.0,
    device: str = "cuda",
    wandb_project: Optional[str] = None,
    wandb_entity: Optional[str] = None,
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
    mesh=None,
    noise_file: Optional[str] = None,
    async_frames: bool = False,
    log_losses: bool = False,
    strict_parity: bool = True,
    dpm_solver: bool = False,
    fast_guidance: bool = False,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    stall_pet=None,
    device_lock=None,
) -> Iterator[Tuple[int, str]]:
    if mesh is not None and any(d.type != torch.device(device).type for d in mesh.devices.flat):
        raise ValueError(f"device={device!r} but the mesh's devices are {list(mesh.devices.flat)}")
    dev = resolve_device(device)
    _refuse(
        use_augs=(use_augs, False),
        dpm_solver=(dpm_solver, False), fast_guidance=(fast_guidance, False),
        checkpoint_path=(checkpoint_path, None), resume_from=(resume_from, None),
        reduce_clip=(reduce_clip, False), progressive_cutout=(progressive_cutout, False),
        height_offset=(height_offset, 0), width_offset=(width_offset, 0),
        wandb_project=(wandb_project, None), wandb_entity=(wandb_entity, None),
        noise_file=(noise_file, None),
        async_frames=(async_frames, False), log_losses=(log_losses, False),
        stall_pet=(stall_pet, None), device_lock=(device_lock, None),
    )
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got {compute_dtype!r}")
    if dev.type == "cuda" and compute_dtype != "bfloat16":
        raise ValueError("compute_dtype='float32' on CUDA: the conv kernels take bfloat16")

    prompts, image_prompts = list(prompts), list(image_prompts)
    check_parameters(
        prompts=prompts, image_prompts=image_prompts, image_size=image_size,
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
    if mesh is not None:
        dev = mesh.main
        data_size = mesh.shape["data"]
        if batch_size % data_size != 0:
            raise ValueError(
                f"batch_size {batch_size} is not divisible by the mesh "
                f"'data' axis ({data_size}) — use --mesh data=N with "
                "N dividing the batch, or --mesh auto/cut=M for batch 1"
            )
        if num_cutouts % mesh.size != 0:
            say(
                f"(warning) num_cutouts {num_cutouts} is not divisible by "
                f"the {mesh.size}-device mesh; cutout shards will be uneven"
            )
        say(f"Mesh engaged: {mesh.shape}")
    Path(prefix_path).mkdir(parents=True, exist_ok=True)
    if weights_mode != "random":  # the checkpoints and their caches live there
        Path(checkpoints_dir).mkdir(parents=True, exist_ok=True)
    cdtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32

    # ---- models -------------------------------------------------------
    clip_model, clip_cfg = resolve_clip(clip_model_name, weights_mode, dev, checkpoints_dir)
    unet, unet_cfg, flags = resolve_unet(
        image_size, class_cond, weights_mode,
        flag_overrides={"diffusion_steps": diffusion_steps, "noise_schedule": noise_schedule},
        device=dev, checkpoints_dir=checkpoints_dir,
    )
    if cdtype == torch.bfloat16:
        cast_conv_params(unet, cdtype)
        cast_conv_params(clip_model, cdtype)
    if mesh is not None:
        shard_params_replicated(unet, mesh)  # the split ops find the copies
    if weights_mode == "random":
        tokenizer = _FallbackTokenizer(clip_cfg.text.vocab_size)
    else:
        from cgd_tpu_torch.models.clip.tokenizer import get_tokenizer

        tokenizer = get_tokenizer()
    gen = torch.Generator(dev).manual_seed(seed)

    # ---- prompt encoding ----------------------------------------------
    embeds, weights = [], []
    parsed = [parse_prompt(p) for p in prompts]
    if parsed:
        tokens = tokenizer.tokenize([t for t, _ in parsed],
                                    context_length=clip_cfg.text.context_length)
        with torch.no_grad():
            embeds.append(encode_text(clip_model, torch.as_tensor(tokens, device=dev)))
        weights += [w for _, w in parsed]
    for image_prompt in image_prompts:
        path, weight = parse_prompt(image_prompt)
        img = _prompt_image(path, image_size, dev)
        spec = sample_cutout_coords(gen, num_cutouts, img.shape[1], img.shape[0],
                                    clip_cfg.input_resolution)
        embeds.append(encode_image_prompt(clip_model, clip_cfg, img, spec, strict_parity))
        weights += [weight / num_cutouts] * num_cutouts
    target_embeds = torch.cat(embeds)
    weights = torch.as_tensor(normalize_weights(weights), device=dev)

    # ---- init image ---------------------------------------------------
    init_tensor = lpips = None
    if init_image:
        arr = load_image_rgb(init_image, image_size)
        init_tensor = torch.from_numpy(arr)[None].repeat(batch_size, 1, 1, 1).to(dev)
        if init_scale != 0:
            lpips = resolve_lpips(weights_mode, dev, checkpoints_dir)

    # ---- diffusion, guidance, sampler ---------------------------------
    diffusion = make_diffusion(
        steps=flags.get("diffusion_steps", 1000),
        noise_schedule=flags.get("noise_schedule", "linear"),
        timestep_respacing=timestep_respacing,
        rescale_timesteps=flags.get("rescale_timesteps", False),
        learn_sigma=flags.get("learn_sigma", True),
    )
    cached_coords = None
    if cached_cutouts:
        cached_coords = sample_cutout_coords(
            gen, num_cutouts, image_size, image_size, clip_cfg.input_resolution, cutout_power)
    settings = GuidanceSettings(
        clip_guidance_scale=clip_guidance_scale, tv_scale=tv_scale,
        range_scale=range_scale, sat_scale=sat_scale, init_scale=init_scale,
        use_magnitude=use_magnitude, cutout_power=cutout_power,
        clip_compute_dtype=compute_dtype,
    )
    builder = make_guidance_builder(
        clip_model, clip_cfg, target_embeds, weights, diffusion, settings,
        cached_coords=cached_coords, mesh=mesh, lpips=lpips,
        init_image=init_tensor if lpips is not None else None)
    sampler_cfg = SamplerConfig(
        use_ddim=timestep_respacing.startswith("ddim"),
        randomize_class=(randomize_class and class_cond),
        num_classes=1000,
    )

    def model_fn(x, t_model, y):
        # an image height the 'cut' axis does not divide runs whole, as its
        # levels below one that it does not divide (parallel/mesh.py)
        if mesh is None or x.shape[1] % mesh.shape["cut"]:
            return unet(x, t_model, y, compute_dtype=cdtype)
        # split x over the mesh, run the split UNet, gather the output whole
        return unet(split_activation(x, mesh), t_model, y, compute_dtype=cdtype).gather()

    y_init = torch.zeros((batch_size,), dtype=torch.long, device=dev) if class_cond else None
    shape = (batch_size, image_size, image_size, 3)
    say(f"Sampling {diffusion.num_timesteps - skip_timesteps} steps at {image_size}px on {dev}")
    t0 = time.perf_counter()
    for step_k, pred_x0, _x_t in sample_loop(
        diffusion, model_fn, builder, shape, gen, sampler_cfg,
        skip_timesteps=skip_timesteps, init_image=init_tensor,
        num_cutouts=num_cutouts, save_frequency=save_frequency, y_init=y_init,
        final_frame_parity=strict_parity,
    ):
        frames = pred_x0.float().cpu().numpy()
        for batch_idx in range(batch_size):
            yield batch_idx, log_image(frames[batch_idx], prefix_path, prompts, step_k, batch_idx)
    say(f"Sampled in {time.perf_counter() - t0:.1f} s")
