"""Public API of the port: the ``clip_guided_diffusion`` generator.

Counterpart of ``cgd_tpu/api.py``: same keyword names, same generator
contract — yields ``(batch_idx, saved_frame_path)`` per saved frame — and the
same output tree. The slice ported so far: text prompts with weights and
image prompts, class-conditional or unconditional ADM UNet (64-512px) with
the published checkpoints (``weights_mode="auto"``: the reference's
``.pt`` files in ``checkpoints_dir``, converted once to the JAX package's
``.npz.cgd`` cache) or random weights, any CLIP tower (ViT or
ModifiedResNet, or a local ``.pt``), the CLIP BPE tokenizer, DDIM
(``timestep_respacing="ddimN"``), ancestral or DPM-Solver++(2M)
(``dpm_solver``) sampling, ``fast_guidance``, an init image with
``skip_timesteps`` and the LPIPS VGG loss (``init_scale``), cutouts (fresh
or cached, ``progressive_cutout``) and their augmentations (``use_augs``),
``reduce_clip``, the spherical / TV / range / saturation losses, the
magnitude clamp, non-square samples (``height_offset`` / ``width_offset``),
recorded noise (``noise_file``: an npz of ``init`` [b, h, w, 3] and
``steps`` [n, b, h, w, 3]), ``strict_parity`` either way, and ``mesh=``
(``cgd_tpu_torch.parallel.mesh``): batch split over 'data', the UNet's
activations split by height over 'cut' (every 3x3 conv on K-halo), the
cutouts split over every mesh device. Also the JAX package's run services:
``checkpoint_path`` / ``resume_from`` (the sampling state after every
segment, the generator's state with it; a resumed run gives the
uninterrupted run's frames), ``log_losses`` (a line of loss scalars per
guided step), W&B (``wandb_project``: the scalars and the per-step
triptych; without ``wandb`` the run says so and goes on), ``async_frames``
(PNG writes on a background thread), ``stall_pet`` (a progress callback for
``utils.watchdog.StallDetector``) and ``device_lock`` (the serving daemon's
lock around the device-heavy part of a run). Nothing is refused. On one
card the guided steps replay CUDA graphs (``diffusion/sampler.py``) except
with a ``mesh``, ``log_losses`` / W&B (the losses read on the host each
step) or a ``device_lock``, whose other holders prepare on the card while
this call samples (a capture fails under another thread's device work). A
checkpoint's UNet and CLIP stay on the device between calls in one process
(``weights.py``'s model cache): a call with the same files, configuration,
device and ``compute_dtype`` as the last one reuses its modules. With
``utils.tracing`` enabled the call records its spans: ``api.request`` from
entry to return, and below it the models, the prompts, each segment and
step of the loop and each frame (the caller's time at a yield in none).

``compute_dtype="float32"`` runs the UNet, CLIP and the glue in f32 (the
conv family and the attention on their f32 kernels on a card; with
``mesh=`` the height-split convs on K-halo f32) with TF32 off for cuDNN and
cuBLAS while the run's device work goes on, and the caller's flags back
whenever it yields or ends. The flags are process-global, so with a
``device_lock`` only the lock's holder sets them, and an f32 run takes the
lock before its prompt encoding (a bfloat16 run's prep stays outside it):
two generators interleaved through one lock each see their own flags.

The UNet forward is rematerialized under the guidance gradient where
``_resolve_remat`` says its saved activations would not fit the card
(``CGD_TPU_REMAT=0/1`` forces either way); the decision is part of the run
meta, and a resume adopts the checkpoint's.

The signature is ``cgd_tpu.api.clip_guided_diffusion``'s, keyword for keyword
and default for default (tests/test_torch_port_api.py pins it), except
``device``: it defaults to ``"cuda"``, and with no card that is an error. The
CPU is used only when the caller passes ``device="cpu"``. ``dropout`` is
taken and, as in the JAX package's sampling, never applied.
"""

from __future__ import annotations

import hashlib
import json
import os
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
from cgd_tpu_torch.io_utils.images import (
    decode_image,
    flush_frames,
    load_image_rgb,
    log_image,
    to_uint8,
)
from cgd_tpu_torch.models.clip.configs import CLIP_MEAN, CLIP_STD, CLIPConfig
from cgd_tpu_torch.models.clip.model import CLIP, encode_image, encode_text
from cgd_tpu_torch.models.unet import rematerialized
from cgd_tpu_torch.ops.resample import resize
from cgd_tpu_torch.parallel.mesh import shard_params_replicated, split_activation
from cgd_tpu_torch.utils import tracing
from cgd_tpu_torch.validate import OOM_ADVICE, check_parameters
from cgd_tpu_torch.weights import (
    CACHE_PATH,
    cache_counts,
    resolve_clip,
    resolve_lpips,
    resolve_unet,
)


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


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """The torch dtype a run's ``compute_dtype`` names: the UNet's and CLIP's
    compute, and their conv kernels' (the model cache keys on it)."""
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


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


class _TF32Off:
    """cuDNN's and cuBLAS's TF32 off between ``enter()`` and ``exit()``
    (PyTorch's default lets cuDNN run f32 convolutions at TF32), the flags
    found at ``enter()`` back at ``exit()``; both idempotent. The flags are
    process-global: with a device lock only its holder calls these."""

    def __init__(self):
        self.saved = None

    def enter(self) -> None:
        if self.saved is None:
            cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
            self.saved = cudnn.allow_tf32, matmul.allow_tf32
            cudnn.allow_tf32 = matmul.allow_tf32 = False

    def exit(self) -> None:
        if self.saved is not None:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
            self.saved = None


# the no-remat 512px guided step's peak device memory in GiB at batch b and
# c cutouts, bf16, fit to chip_smoke.py phase 14c's grid (512px RN50x16,
# NVIDIA H100 80GB HBM3, 700 W; within 0.6 GiB of the largest peak each
# point read over three runs):
# (_REMAT_FIXED + _REMAT_FIXED_PER_CUTOUT * c)
#     + b * (_REMAT_PER_IMAGE + _REMAT_PER_IMAGE_CUTOUT * c)
_REMAT_FIXED, _REMAT_FIXED_PER_CUTOUT = -1.688, 0.253
_REMAT_PER_IMAGE, _REMAT_PER_IMAGE_CUTOUT = 2.774, 0.157
_REMAT_LIMIT_GIB = 0.9 * 79.2  # 90% of what torch reports for the 80 GB card


def _resolve_remat(image_size: int, batch_size: int, num_cutouts: int) -> bool:
    """Should the UNet forward rematerialize under the guidance gradient?
    The signature and the ``CGD_TPU_REMAT=0/1`` override of
    ``cgd_tpu.api._resolve_remat``; the thresholds are the H100's, not the
    TPU v5e's of the JAX package.

    Only where the no-remat step does not fit with headroom: its peak
    device memory, reckoned from the 512px grid (chip_smoke.py phase 14c;
    bf16, NVIDIA H100 80GB HBM3, 700 W), over 90% of the card's 79.2 GiB.
    Peak GiB with no remat / full remat / ``remat_min_dim=128``, the
    largest of three runs (the smaller 32-cutout points moved by up to 3.8
    GiB from run to run):

        b=1 cutn16   7.65 /  5.29 /  6.63
        b=8 cutn16  44.68 / 26.55 / 37.76
        b=1 cutn32  14.44 /  8.32 /  9.66
        b=8 cutn32  68.75 / 50.60 / 64.33

    Whole-UNet remat costs 11-34% a step and saves 26-42% of the peak (the
    CLIP tower's activations over b * cutn cutouts stay); the gate engages
    from b = 14 at 16 cutouts, b = 9 at 32, b = 5 at 64. Smaller images
    never remat (the JAX package's rule too): the 256px step peaks at 3.4
    GiB at b = 1 and 7.2 at b = 4 (phase 14b).

    ``CGD_TPU_REMAT`` is read on every call. The decision is part of the
    run meta, and a resume adopts the checkpoint's recorded decision, so a
    change of these numbers cannot make an old checkpoint unresumable."""
    env = os.environ.get("CGD_TPU_REMAT", "").strip()
    if env in ("0", "1"):
        return env == "1"
    if image_size < 512:
        return False
    peak = (_REMAT_FIXED + _REMAT_FIXED_PER_CUTOUT * num_cutouts
            + batch_size * (_REMAT_PER_IMAGE + _REMAT_PER_IMAGE_CUTOUT * num_cutouts))
    return peak > _REMAT_LIMIT_GIB


def _write_checkpoint(path: str, data: dict) -> None:
    """The sampling state as an npz, atomically (``.tmp`` + ``os.replace``):
    a reader never sees half a file."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **data)
    os.replace(tmp, path)


def _read_checkpoint(path: str, run_meta: dict, device_type: str) -> dict:
    """The resume state of checkpoint ``path`` for a run of meta
    ``run_meta`` drawing on ``device_type``, with the UNet remat decision
    it was written under (``unet_remat``), which the resumed run adopts in
    place of its own: the meta is compared with that value in. A
    checkpoint without the key was written before the decision joined the
    meta, when no run of this package rematerialized: it reads as False.
    Raises ValueError for a file that is unreadable or whose meta does not
    parse, one the JAX package wrote (no generator state, another random
    stream), one drawn on another device type, and one of another run
    configuration, each in its own words."""
    try:
        rec = np.load(path)
        meta = str(rec["meta"])
    except Exception as e:
        raise ValueError(f"resume_from {path!r} is not a readable checkpoint ({e})") from e
    try:
        saved = json.loads(meta)
        if not isinstance(saved, dict):
            raise TypeError(f"meta is a {type(saved).__name__}")
    except Exception as e:
        raise ValueError(f"resume_from {path!r}: its run meta does not parse ({e}); "
                         "the checkpoint is corrupt") from e
    if saved.get("package") != "cgd_tpu_torch" or "generator" not in rec.files:
        raise ValueError(
            f"resume_from {path!r} was written by the JAX package cgd_tpu (or another "
            "writer): it holds no torch.Generator state, and cgd_tpu draws its noise from "
            "keys split from the seed, so continuing it here would give a different image")
    if saved.get("generator") != device_type:
        raise ValueError(
            f"resume_from {path!r} was written on device type {saved.get('generator')!r}, "
            f"this run draws on {device_type!r}: the two generators' streams differ, so "
            "continuing it here would give a different image")
    saved.setdefault("unet_remat", False)
    saved_meta = json.dumps(saved, sort_keys=True)
    this_meta = json.dumps(dict(run_meta, unet_remat=saved["unet_remat"]), sort_keys=True)
    if saved_meta != this_meta:
        raise ValueError(
            "resume_from checkpoint was written by a different run "
            f"configuration:\n  saved: {saved_meta}\n  this:  {this_meta}")
    return {
        "unet_remat": bool(saved["unet_remat"]),
        "next_seg": int(rec["next_seg"]),
        "x": rec["x"],
        "y": rec["y"] if "y" in rec.files else None,
        "x0p": rec["x0p"] if "x0p" in rec.files else None,
        "generator": rec["generator"],
    }


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
    config = dict(locals())  # the call's arguments, W&B's run config
    with tracing.request("api.request", batch=batch_size) as request:
        if mesh is not None and any(d.type != torch.device(device).type for d in mesh.devices.flat):
            raise ValueError(
                f"device={device!r} but the mesh's devices are {list(mesh.devices.flat)}")
        dev = resolve_device(device)
        if compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'bfloat16' or 'float32', got {compute_dtype!r}")

        def say(msg):
            if progress:
                print(msg, flush=True)

        wandb_run = wandb = None
        if wandb_project is not None:
            try:
                import wandb

                wandb_run = wandb.init(project=wandb_project, entity=wandb_entity, config=config)
            except Exception as e:  # wandb not installed / offline
                say(f"W&B unavailable ({e}); continuing without logging.")
        else:
            say("--wandb_project not specified. Skipping W&B integration.")

        prompts, image_prompts = list(prompts), list(image_prompts)
        check_parameters(
            prompts=prompts, image_prompts=image_prompts, image_size=image_size,
            timestep_respacing=timestep_respacing, diffusion_steps=diffusion_steps,
            clip_model_name=clip_model_name, save_frequency=save_frequency,
            noise_schedule=noise_schedule,
        )
        pet = stall_pet if stall_pet is not None else (lambda phase: None)

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
        cdtype = torch_dtype(compute_dtype)

        # ---- models -------------------------------------------------------
        pet("resolve model checkpoints")
        # a checkpoint's models come from weights.py's model cache where the
        # last call of their role had the same files, config, device and dtype
        with tracing.span("api.models") as models_span, cache_counts() as counts:
            clip_model, clip_cfg = resolve_clip(clip_model_name, weights_mode, dev,
                                                checkpoints_dir, conv_dtype=cdtype)
            unet, unet_cfg, flags = resolve_unet(
                image_size, class_cond, weights_mode,
                flag_overrides={"diffusion_steps": diffusion_steps,
                                "noise_schedule": noise_schedule},
                device=dev, checkpoints_dir=checkpoints_dir, conv_dtype=cdtype,
            )
            if mesh is not None:
                shard_params_replicated(unet, mesh)  # the split ops find the copies
            models_span.note(**counts)
        if weights_mode == "random":
            tokenizer = _FallbackTokenizer(clip_cfg.text.vocab_size)
        else:
            from cgd_tpu_torch.models.clip.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        gen = torch.Generator(dev).manual_seed(seed)

        # The device-heavy part runs holding ``device_lock`` when one is given
        # (the daemon's: weight resolution, tokenization and validation above
        # overlap another request's sampling); an f32 run takes it before its
        # prompt encoding, since only the holder may set the TF32 flags.
        prec = _TF32Off() if cdtype == torch.float32 else None
        held = False

        def take_device():
            nonlocal held
            if device_lock is not None and not held:
                # keep petting while queued behind another generation's device
                # phase: waiting for the card is not a stall
                pet("waiting for device lock")
                while not device_lock.acquire(timeout=5.0):
                    pet("waiting for device lock")
                held = True
            if prec is not None:
                prec.enter()

        try:
            if prec is not None:
                take_device()

            # ---- prompt encoding ------------------------------------------
            pet("encode prompts")
            with tracing.span("api.prompts", prompts=len(prompts) + len(image_prompts)):
                embeds, weights = [], []
                parsed = [parse_prompt(p) for p in prompts]
                if parsed:
                    tokens = tokenizer.tokenize([t for t, _ in parsed],
                                                context_length=clip_cfg.text.context_length)
                    with torch.no_grad():
                        embeds.append(encode_text(clip_model,
                                                  torch.as_tensor(tokens, device=dev)))
                    weights += [w for _, w in parsed]
                for image_prompt in image_prompts:
                    path, weight = parse_prompt(image_prompt)
                    img = _prompt_image(path, image_size, dev)
                    spec = sample_cutout_coords(gen, num_cutouts, img.shape[1], img.shape[0],
                                                clip_cfg.input_resolution)
                    embeds.append(encode_image_prompt(clip_model, clip_cfg, img, spec,
                                                      strict_parity))
                    weights += [weight / num_cutouts] * num_cutouts
                target_embeds = torch.cat(embeds)
                weights = torch.as_tensor(normalize_weights(weights), device=dev)
            if use_augs:
                say("Augmentations enabled.")

            # ---- init image -----------------------------------------------
            init_tensor = lpips = None
            side_y, side_x = image_size + height_offset, image_size + width_offset
            if init_image:
                if (height_offset or width_offset) and strict_parity:
                    # the reference resizes the init square (cgd/cgd.py:118) while
                    # the sample shape carries the offsets (cgd/cgd.py:252), and
                    # q_sample then fails on the shapes: fail loudly, as the JAX
                    # package does
                    raise ValueError(
                        "init_image with height/width offsets is broken in the "
                        "reference (init resized to "
                        f"({image_size},{image_size}) but sample shape is "
                        f"({side_y},{side_x})); "
                        "pass strict_parity=False to resize the init to the offset shape"
                    )
                arr = load_image_rgb(init_image, (side_x, side_y))
                init_tensor = torch.from_numpy(arr)[None].repeat(batch_size, 1, 1, 1).to(dev)
                if init_scale != 0:
                    lpips = resolve_lpips(weights_mode, dev, checkpoints_dir)

            # ---- diffusion, guidance, sampler -----------------------------
            diffusion = make_diffusion(
                steps=flags.get("diffusion_steps", 1000),
                noise_schedule=flags.get("noise_schedule", "linear"),
                timestep_respacing=timestep_respacing,
                rescale_timesteps=flags.get("rescale_timesteps", False),
                learn_sigma=flags.get("learn_sigma", True),
            )
            if reduce_clip and skip_timesteps == 0:
                skip_timesteps = int(diffusion.num_timesteps * 0.2)
                say(f"Skipping first {skip_timesteps} timesteps (--reduce-clip optimization)")
            cached_coords = None
            if cached_cutouts:
                # progressive_cutout floors a step's count at 4 / 8 cutouts, so
                # the cache holds as many as the largest step takes
                cache_n = max(num_cutouts, 8) if progressive_cutout else num_cutouts
                cached_coords = sample_cutout_coords(
                    gen, cache_n, side_x, side_y, clip_cfg.input_resolution, cutout_power)
            settings = GuidanceSettings(
                clip_guidance_scale=clip_guidance_scale, tv_scale=tv_scale,
                range_scale=range_scale, sat_scale=sat_scale, init_scale=init_scale,
                use_magnitude=use_magnitude, use_augs=use_augs, cutout_power=cutout_power,
                clip_compute_dtype=compute_dtype,
            )

            loss_cb = image_sink = None
            if log_losses or wandb_run is not None:
                # per guided step, as the JAX package's live host callback (the
                # reference's tqdm.write + wandb.log, cgd/cgd.py:234-238); the
                # step's gradient scalars come in a second call, which has no
                # loss line (the JAX package prints an empty one)
                def loss_cb(log):
                    line = "\t".join(f"{k}: {v:.3f}" for k, v in log.items() if "loss" in k.lower())
                    if log_losses and line:
                        print(line, flush=True)
                    if wandb_run is not None:
                        wandb_run.log(dict(log))
            if wandb_run is not None:
                sqrt_om = np.asarray(diffusion.sqrt_one_minus_alphas_cumprod)

                def image_sink(step_ks, noisy, preds):
                    # the reference's triptych every guided step (cgd/cgd.py:180-186):
                    # noisy sample, denoised prediction, their blend (what CLIP sees);
                    # uint8 arrays, so that no Pillow is needed
                    for i, step_k in enumerate(step_ks):
                        fac = float(sqrt_om[max(diffusion.num_timesteps - 1 - step_k, 0)])
                        blend = preds[i] * fac + noisy[i] * (1.0 - fac)
                        wandb_run.log({
                            f"Generations - {timestep_respacing}": [
                                wandb.Image(to_uint8(noisy[i][0]), caption="Noisy Sample"),
                                wandb.Image(to_uint8(preds[i][0]), caption="Denoised Prediction"),
                                wandb.Image(to_uint8(blend[0]), caption="Blended (what CLIP sees)"),
                            ],
                            "step": step_k,
                        })

            builder = make_guidance_builder(
                clip_model, clip_cfg, target_embeds, weights, settings,
                cached_coords=cached_coords, mesh=mesh, lpips=lpips,
                init_image=init_tensor if lpips is not None else None, loss_callback=loss_cb)
            sampler_cfg = SamplerConfig(
                use_ddim=timestep_respacing.startswith("ddim"),
                randomize_class=(randomize_class and class_cond),
                num_classes=1000,
                fast_guidance=fast_guidance,
                dpm_solver=dpm_solver,
            )

            y_init = (torch.zeros((batch_size,), dtype=torch.long, device=dev)
                      if class_cond else None)
            shape = (batch_size, side_y, side_x, 3)
            init_noise = noise_steps = None
            if noise_file:  # recorded noise: {"init": [*shape], "steps": [n_steps, *shape]}
                rec = np.load(noise_file)
                init_noise = rec["init"] if "init" in rec.files else None
                noise_steps = rec["steps"] if "steps" in rec.files else None

            # ---- checkpoint / resume --------------------------------------
            # everything that shapes the remaining segments or their guidance:
            # the JAX package's run meta (cgd_tpu/api.py:755-785), plus this
            # package's name and the device type the generator draws on (its
            # stream, saved with the state, differs between devices)
            use_remat = _resolve_remat(image_size, batch_size, num_cutouts)
            run_meta = {
                "seed": seed, "shape": list(shape),
                "timestep_respacing": timestep_respacing,
                "diffusion_steps": diffusion_steps, "noise_schedule": noise_schedule,
                "skip_timesteps": int(skip_timesteps), "num_cutouts": int(num_cutouts),
                "save_frequency": int(save_frequency), "reduce_clip": reduce_clip,
                "progressive_cutout": progressive_cutout,
                "fast_guidance": fast_guidance, "dpm_solver": dpm_solver,
                "class_cond": class_cond,
                "randomize_class": randomize_class, "strict_parity": strict_parity,
                "prompts": list(prompts), "image_prompts": list(image_prompts),
                "clip_model_name": clip_model_name,
                # numeric knobs as floats: the API's int defaults and the CLI's
                # argparse floats must give the same meta
                "clip_guidance_scale": float(clip_guidance_scale),
                "tv_scale": float(tv_scale),
                "range_scale": float(range_scale), "sat_scale": float(sat_scale),
                "init_scale": float(init_scale), "cutout_power": float(cutout_power),
                "use_augs": use_augs, "use_magnitude": use_magnitude,
                "cached_cutouts": cached_cutouts, "compute_dtype": compute_dtype,
                "package": "cgd_tpu_torch", "generator": dev.type,
                # the remat decision: a resume replays the graph its checkpoint
                # was written under
                "unet_remat": use_remat,
            }
            resume_state = state_sink = None
            if resume_from:
                resume_state = _read_checkpoint(resume_from, run_meta, dev.type)
                use_remat = run_meta["unet_remat"] = resume_state["unet_remat"]
                say(f"Resuming from {resume_from} at segment {resume_state['next_seg']}.")
            run_meta = json.dumps(run_meta, sort_keys=True)

            def unet_fn(x, t_model, y):
                # an image height the 'cut' axis does not divide runs whole, as
                # its levels below one that it does not divide (parallel/mesh.py)
                if mesh is None or x.shape[1] % mesh.shape["cut"]:
                    return unet(x, t_model, y, compute_dtype=cdtype)
                # split x over the mesh, run the split UNet, gather the output whole
                return unet(split_activation(x, mesh), t_model, y, compute_dtype=cdtype).gather()

            # the guidance gradient backprops through the UNet: recompute its
            # forward in the backward (time for memory) where _resolve_remat says
            model_fn = rematerialized(unet_fn) if use_remat else unet_fn
            if checkpoint_path:
                os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)

                def state_sink(next_seg, st):
                    data = {"next_seg": next_seg, "x": st["x"], "generator": st["generator"],
                            "meta": run_meta}
                    if st["y"] is not None:
                        data["y"] = st["y"]
                    if st["x0p"] is not None:  # dpm_solver multistep state
                        data["x0p"] = st["x0p"]
                    _write_checkpoint(checkpoint_path, data)

            steps_done = 0

            def progress_cb(n_steps):
                # after every segment: the finest liveness signal a hung card
                # cannot fake
                nonlocal steps_done
                steps_done += n_steps
                pet(f"sampling ({steps_done} steps done)")

            take_device()
            pet("compile + first sampling segment")
            say(f"Sampling {diffusion.num_timesteps - skip_timesteps} steps at "
                f"{side_y}x{side_x}px on {dev}")
            request.note(steps=diffusion.num_timesteps - skip_timesteps)
            t0 = time.perf_counter()
            try:
                for step_k, pred_x0, _x_t in sample_loop(
                    diffusion, model_fn, builder, shape, gen, sampler_cfg,
                    skip_timesteps=skip_timesteps, init_image=init_tensor,
                    reduce_clip=reduce_clip, progressive_cutout=progressive_cutout,
                    num_cutouts=num_cutouts, save_frequency=save_frequency, y_init=y_init,
                    noise_override=noise_steps, init_noise=init_noise,
                    final_frame_parity=strict_parity, progress_cb=progress_cb,
                    image_sink=image_sink, state_sink=state_sink, resume=resume_state,
                    mesh=mesh, shared_device=device_lock is not None,
                ):
                    with tracing.span("images.to_host", k=step_k):
                        frames = pred_x0.float().cpu().numpy()
                    for batch_idx in range(batch_size):
                        path = log_image(frames[batch_idx], prefix_path, prompts, step_k,
                                         batch_idx, use_async=async_frames)
                        if prec is not None:  # the caller's flags while suspended
                            prec.exit()
                        with tracing.detached(request):  # the caller's time is its own
                            yield batch_idx, path
                        if prec is not None:
                            prec.enter()
            except KeyboardInterrupt:
                # the frames written so far stay; the caller goes on with them
                # (cgd_tpu/api.py:890-891, the reference's cgd/cgd.py:274-276)
                say("Interrupted — partial frames kept.")
                return
            except RuntimeError as e:
                if _out_of_memory(e):  # the reference's CUDA-OOM advice (cgd/cgd.py:277-283)
                    print(OOM_ADVICE)
                    print(f"(CLIP model currently: {clip_model_name})")
                raise
            say(f"Sampled in {time.perf_counter() - t0:.1f} s")
        finally:
            if prec is not None:
                prec.exit()
            if held:
                device_lock.release()
            if async_frames:
                failed = flush_frames()
                if failed:
                    print(f"(warning) {failed} asynchronous frame write(s) failed")
            if wandb_run is not None:
                wandb_run.finish()


def _out_of_memory(e: BaseException) -> bool:
    """A device allocation failed: torch.cuda.OutOfMemoryError, or a
    RuntimeError whose text says so (cuDNN's and cuBLAS's own)."""
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e).lower()
