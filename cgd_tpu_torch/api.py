"""Public API of the port: the ``clip_guided_diffusion`` generator.

Counterpart of ``cgd_tpu/api.py``: same keyword names, same generator
contract — yields ``(batch_idx, saved_frame_path)`` per saved frame — and the
same output tree. Nothing is refused: the ADM UNets (64-512px) from the
reference's checkpoints (``weights_mode="auto"``: the ``.pt`` files in
``checkpoints_dir``, converted once to the ``.npz.cgd`` cache) or random
weights, any CLIP tower, every sampler, guidance and cutout option, recorded
noise (``noise_file``: an npz of ``init`` [b, h, w, 3] and ``steps`` [n, b,
h, w, 3]), ``mesh=`` (``parallel.mesh``: batch over 'data', the UNet by
height over 'cut', the cutouts over every device) and the JAX package's run
services (``checkpoint_path`` / ``resume_from``, ``log_losses``, W&B,
``async_frames``, ``stall_pet``, the serving daemon's ``device_lock``).

A call runs in named stages: its checks, W&B, the models (kept on the device
across calls by ``weights.py``'s model cache), the prompts
(``_encode_prompts``), the init image (``_init_image``), the diffusion, the
guidance with its host sinks (``_host_sinks``) and the sampler, the run meta
(``_run_meta``) and resume, then the loop. On one card the guided steps
replay CUDA graphs (``diffusion/sampler.py``) except with a ``mesh``,
``log_losses`` / W&B (the losses read on the host each step) or a
``device_lock``, whose other holders work on the card while this call
samples. With ``utils.tracing`` enabled the call records its spans:
``api.request`` from entry to return, and below it the models, the prompts,
each segment and step of the loop and each frame (the caller's time at a
yield in none).

``_DeviceHold`` holds the process-global device state: the ``device_lock``
and, at ``compute_dtype="float32"`` (the UNet, CLIP and the glue in f32),
cuDNN's and cuBLAS's TF32 off, with the caller's flags back whenever the
generator yields or ends. Only the lock's holder sets the flags, so an f32
run takes the hold before its prompt encoding and a bfloat16 run just before
sampling: two generators interleaved through one lock each see their own.

The signature is ``cgd_tpu.api.clip_guided_diffusion``'s, keyword for keyword
and default for default (tests/test_torch_port_api.py pins it), except
``device``: it defaults to ``"cuda"``, and with no card that is an error. The
CPU is used only when the caller passes ``device="cpu"``. ``dropout`` is
taken and, as in the JAX package's sampling, never applied.
"""

from __future__ import annotations

import contextlib
import functools
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
from cgd_tpu_torch.models.clip.tokenizer import get_tokenizer
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


# the no-remat 512px step's peak GiB at batch b and c cutouts, fit to the grid
# below within 0.6 GiB of each point's largest peak: (_REMAT_FIXED +
# _REMAT_FIXED_PER_CUTOUT * c) + b * (_REMAT_PER_IMAGE + _REMAT_PER_IMAGE_CUTOUT * c)
_REMAT_FIXED, _REMAT_FIXED_PER_CUTOUT = -1.688, 0.253
_REMAT_PER_IMAGE, _REMAT_PER_IMAGE_CUTOUT = 2.774, 0.157
_REMAT_LIMIT_GIB = 0.9 * 79.2  # 90% of what torch reports for the 80 GB card


def _resolve_remat(image_size: int, batch_size: int, num_cutouts: int) -> bool:
    """Should the UNet forward rematerialize under the guidance gradient?
    The signature and the ``CGD_TPU_REMAT=0/1`` override of
    ``cgd_tpu.api._resolve_remat``; the thresholds are the H100's, not the
    TPU v5e's of the JAX package.

    Only where the no-remat step does not fit with headroom: its peak
    device memory over 90% of the card's 79.2 GiB. Peak GiB with no remat
    / full remat / ``remat_min_dim=128``, the largest of three runs of
    chip_smoke.py phase 14c (512px RN50x16, bf16, NVIDIA H100 80GB HBM3,
    700 W; the smaller 32-cutout points moved by up to 3.8 GiB):

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
    a reader never sees half a file. Entries that are None are left out."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: v for k, v in data.items() if v is not None})
    os.replace(tmp, path)


def _read_checkpoint(path: str, run_meta: dict, device_type: str) -> dict:
    """The resume state of checkpoint ``path`` for a run of meta
    ``run_meta`` drawing on ``device_type``, with the remat decision it was
    written under (``unet_remat``; False where the key predates it), which
    the resumed run adopts: the meta is compared with it in. Raises
    ValueError, each in its own words, for a file unreadable or whose meta
    does not parse, one the JAX package wrote (no generator state, another
    random stream), one drawn on another device type or another run
    configuration."""
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


class _DeviceHold:
    """The process-global device state a run holds while its device work
    goes on: the ``device_lock`` where one is given (the daemon's: weight
    resolution, tokenization and validation overlap another request's
    sampling) and, for an f32 run, TF32 off (``_TF32Off``). ``take()`` is
    idempotent and pets every 5 s while queued (waiting for the card is not
    a stall); ``suspended()``, around a ``yield``, gives the caller's flags
    back meanwhile; ``release()`` puts them back, then releases the lock."""

    def __init__(self, device_lock, f32: bool, pet):
        self.lock, self.pet, self.held = device_lock, pet, False
        self.tf32 = _TF32Off() if f32 else None

    def take(self) -> None:
        if self.lock is not None and not self.held:
            self.pet("waiting for device lock")
            while not self.lock.acquire(timeout=5.0):
                self.pet("waiting for device lock")
            self.held = True
        if self.tf32 is not None:
            self.tf32.enter()

    @contextlib.contextmanager
    def suspended(self):
        if self.tf32 is not None:
            self.tf32.exit()
        yield
        if self.tf32 is not None:
            self.tf32.enter()

    def release(self) -> None:
        if self.tf32 is not None:
            self.tf32.exit()
        if self.held:
            self.held = False
            self.lock.release()


def _run_device(device, mesh, compute_dtype: str) -> torch.device:
    """The call's device, its mesh's devices of its type and its dtype checked."""
    if mesh is not None and any(d.type != torch.device(device).type for d in mesh.devices.flat):
        raise ValueError(f"device={device!r} but the mesh's devices are {list(mesh.devices.flat)}")
    dev = resolve_device(device)
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got {compute_dtype!r}")
    return dev


def _mesh_device(mesh, batch_size: int, num_cutouts: int, say) -> torch.device:
    """The device a ``mesh`` run drives, once its batch splits over 'data'."""
    data_size = mesh.shape["data"]
    if batch_size % data_size != 0:
        raise ValueError(f"batch_size {batch_size} is not divisible by the mesh 'data' axis "
                         f"({data_size}) — use --mesh data=N with N dividing the batch, or "
                         "--mesh auto/cut=M for batch 1")
    if num_cutouts % mesh.size != 0:
        say(f"(warning) num_cutouts {num_cutouts} is not divisible by the {mesh.size}-device "
            "mesh; cutout shards will be uneven")
    say(f"Mesh engaged: {mesh.shape}")
    return mesh.main


def _start_wandb(project, entity, config: dict, say):
    """The W&B run, or None without a project or where wandb cannot start."""
    if project is None:
        say("--wandb_project not specified. Skipping W&B integration.")
        return None
    try:
        import wandb

        return wandb.init(project=project, entity=entity, config=config)
    except Exception as e:  # wandb not installed / offline
        say(f"W&B unavailable ({e}); continuing without logging.")
        return None


def _encode_prompts(clip_model: CLIP, clip_cfg: CLIPConfig, tokenizer, prompts, image_prompts,
                    *, image_size: int, num_cutouts: int, strict_parity: bool,
                    gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(target_embeds, weights)``: the text prompts through CLIP's text
    tower, then each image prompt's cutouts (drawn from ``gen``) through its
    image tower, each 1/num_cutouts of its prompt's weight; normalized."""
    embeds, weights = [], []
    parsed = [parse_prompt(p) for p in prompts]
    if parsed:
        tokens = tokenizer.tokenize([t for t, _ in parsed],
                                    context_length=clip_cfg.text.context_length)
        with torch.no_grad():
            embeds.append(encode_text(clip_model, torch.as_tensor(tokens, device=device)))
        weights += [w for _, w in parsed]
    for image_prompt in image_prompts:
        path, weight = parse_prompt(image_prompt)
        img = _prompt_image(path, image_size, device)
        spec = sample_cutout_coords(gen, num_cutouts, img.shape[1], img.shape[0],
                                    clip_cfg.input_resolution)
        embeds.append(encode_image_prompt(clip_model, clip_cfg, img, spec, strict_parity))
        weights += [weight / num_cutouts] * num_cutouts
    return torch.cat(embeds), torch.as_tensor(normalize_weights(weights), device=device)


def _init_image(init_image: Optional[str], *, image_size: int, side_y: int, side_x: int,
                batch_size: int, strict_parity: bool, init_scale: float, weights_mode: str,
                device, checkpoints_dir: str):
    """``(init, lpips)``: the init image [batch, side_y, side_x, 3] on the
    device and, under ``init_scale``, the LPIPS VGG; None where unused."""
    if not init_image:
        return None, None
    if (side_y, side_x) != (image_size, image_size) and strict_parity:
        # the reference resizes the init square (cgd/cgd.py:118) while the
        # sample shape carries the offsets (cgd/cgd.py:252), and q_sample
        # then fails on the shapes: fail loudly, as the JAX package does
        raise ValueError(
            "init_image with height/width offsets is broken in the reference (init resized to "
            f"({image_size},{image_size}) but sample shape is ({side_y},{side_x})); "
            "pass strict_parity=False to resize the init to the offset shape")
    arr = load_image_rgb(init_image, (side_x, side_y))
    init = torch.from_numpy(arr)[None].repeat(batch_size, 1, 1, 1).to(device)
    return init, resolve_lpips(weights_mode, device, checkpoints_dir) if init_scale else None


def _host_sinks(log_losses: bool, wandb_run, diffusion, timestep_respacing: str):
    """``(loss_cb, image_sink)`` for ``log_losses`` and W&B; None where
    unused. ``loss_cb`` gets a guided step's loss scalars (the reference's
    tqdm.write + wandb.log, cgd/cgd.py:234-238), then its gradient scalars,
    which print no line; ``image_sink`` logs the reference's triptych every
    guided step (cgd/cgd.py:180-186) as uint8 arrays, with no Pillow."""
    if not (log_losses or wandb_run is not None):
        return None, None

    def loss_cb(log):
        line = "\t".join(f"{k}: {v:.3f}" for k, v in log.items() if "loss" in k.lower())
        if log_losses and line:
            print(line, flush=True)
        if wandb_run is not None:
            wandb_run.log(dict(log))

    if wandb_run is None:
        return loss_cb, None
    import wandb

    sqrt_om = np.asarray(diffusion.sqrt_one_minus_alphas_cumprod)

    def image_sink(step_ks, noisy, preds):
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

    return loss_cb, image_sink


# the run meta's entries that are the call's arguments as given, and its
# numeric knobs, as floats: the API's int defaults and the CLI's argparse
# floats must give the same meta
_META_ARGS = ("seed", "timestep_respacing", "diffusion_steps", "noise_schedule", "reduce_clip",
              "progressive_cutout", "fast_guidance", "dpm_solver", "class_cond",
              "randomize_class", "strict_parity", "clip_model_name", "use_augs",
              "cached_cutouts", "compute_dtype")
_META_FLOATS = ("clip_guidance_scale", "tv_scale", "range_scale", "sat_scale", "init_scale",
                "cutout_power")


def _run_meta(args: dict, *, skip_timesteps: int, use_magnitude: bool, generator: str,
              unet_remat: bool) -> dict:
    """The meta a checkpoint is keyed on, from the call's arguments and what
    the call settled: the JAX package's run meta (cgd_tpu/api.py:755-785),
    plus this package's name, the device type the generator draws on (its
    stream differs between devices) and the remat decision."""
    meta = {k: args[k] for k in _META_ARGS}
    meta.update({k: float(args[k]) for k in _META_FLOATS})
    size = args["image_size"]
    meta.update(
        shape=[args["batch_size"], size + args["height_offset"], size + args["width_offset"], 3],
        skip_timesteps=int(skip_timesteps), num_cutouts=int(args["num_cutouts"]),
        save_frequency=int(args["save_frequency"]), prompts=list(args["prompts"]),
        image_prompts=list(args["image_prompts"]), use_magnitude=use_magnitude,
        package="cgd_tpu_torch", generator=generator, unet_remat=unet_remat)
    return meta


def _save_state(path: str, run_meta: str, next_seg: int, state: dict) -> None:
    """The sampler's ``state_sink`` under ``checkpoint_path``."""
    _write_checkpoint(path, dict(state, next_seg=next_seg, meta=run_meta))


class _StepsDone:
    """The sampler's ``progress_cb``: a pet after every segment, the finest
    liveness signal a hung card cannot fake."""

    def __init__(self, pet):
        self.pet, self.n = pet, 0

    def __call__(self, n_steps: int) -> None:
        self.n += n_steps
        self.pet(f"sampling ({self.n} steps done)")


def _model_fn(unet, mesh, cdtype: torch.dtype, remat: bool):
    """The UNet as the sampler calls it: over a mesh x split by height over
    'cut' (a height it does not divide runs whole, as in parallel/mesh.py),
    the output gathered whole; under ``remat`` recomputed in the backward."""

    def unet_fn(x, t_model, y):
        if mesh is None or x.shape[1] % mesh.shape["cut"]:
            return unet(x, t_model, y, compute_dtype=cdtype)
        return unet(split_activation(x, mesh), t_model, y, compute_dtype=cdtype).gather()

    return rematerialized(unet_fn) if remat else unet_fn


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
    config = dict(locals())  # the call's arguments: W&B's run config, the run meta's source
    with tracing.request("api.request", batch=batch_size) as request:
        dev = _run_device(device, mesh, compute_dtype)
        say = functools.partial(print, flush=True) if progress else (lambda msg: None)
        wandb_run = _start_wandb(wandb_project, wandb_entity, config, say)
        prompts, image_prompts = list(prompts), list(image_prompts)
        check_parameters(prompts=prompts, image_prompts=image_prompts, image_size=image_size,
                         timestep_respacing=timestep_respacing, diffusion_steps=diffusion_steps,
                         clip_model_name=clip_model_name, save_frequency=save_frequency,
                         noise_schedule=noise_schedule)
        pet = stall_pet if stall_pet is not None else (lambda phase: None)
        if not use_magnitude and image_size == 64:
            use_magnitude = True
            say("Enabling magnitude for 64x64 checkpoints.")
        if mesh is not None:
            dev = _mesh_device(mesh, batch_size, num_cutouts, say)
        Path(prefix_path).mkdir(parents=True, exist_ok=True)
        if weights_mode != "random":  # the checkpoints and their caches live there
            Path(checkpoints_dir).mkdir(parents=True, exist_ok=True)
        cdtype = torch_dtype(compute_dtype)

        # ---- models (weights.py's model cache keeps them across calls) ----
        pet("resolve model checkpoints")
        with tracing.span("api.models") as models_span, cache_counts() as counts:
            clip_model, clip_cfg = resolve_clip(clip_model_name, weights_mode, dev,
                                                checkpoints_dir, conv_dtype=cdtype)
            unet, unet_cfg, flags = resolve_unet(
                image_size, class_cond, weights_mode, device=dev, conv_dtype=cdtype,
                flag_overrides={"diffusion_steps": diffusion_steps,
                                "noise_schedule": noise_schedule}, checkpoints_dir=checkpoints_dir)
            if mesh is not None:
                shard_params_replicated(unet, mesh)  # the split ops find the copies
            models_span.note(**counts)
        tokenizer = (_FallbackTokenizer(clip_cfg.text.vocab_size) if weights_mode == "random"
                     else get_tokenizer())
        gen = torch.Generator(dev).manual_seed(seed)

        hold = _DeviceHold(device_lock, cdtype == torch.float32, pet)
        try:
            if cdtype == torch.float32:  # only the holder sets the flags: from the prompts on
                hold.take()
            pet("encode prompts")
            with tracing.span("api.prompts", prompts=len(prompts) + len(image_prompts)):
                target_embeds, weights = _encode_prompts(
                    clip_model, clip_cfg, tokenizer, prompts, image_prompts,
                    image_size=image_size, num_cutouts=num_cutouts,
                    strict_parity=strict_parity, gen=gen, device=dev)
            if use_augs:
                say("Augmentations enabled.")
            side_y, side_x = image_size + height_offset, image_size + width_offset
            init_tensor, lpips = _init_image(
                init_image, image_size=image_size, side_y=side_y, side_x=side_x,
                batch_size=batch_size, strict_parity=strict_parity, init_scale=init_scale,
                weights_mode=weights_mode, device=dev, checkpoints_dir=checkpoints_dir)

            # ---- diffusion, guidance, sampler -----------------------------
            diffusion = make_diffusion(
                steps=flags.get("diffusion_steps", 1000), timestep_respacing=timestep_respacing,
                noise_schedule=flags.get("noise_schedule", "linear"),
                rescale_timesteps=flags.get("rescale_timesteps", False),
                learn_sigma=flags.get("learn_sigma", True))
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
                clip_compute_dtype=compute_dtype)
            loss_cb, image_sink = _host_sinks(log_losses, wandb_run, diffusion,
                                              timestep_respacing)
            builder = make_guidance_builder(
                clip_model, clip_cfg, target_embeds, weights, settings,
                cached_coords=cached_coords, mesh=mesh, lpips=lpips,
                init_image=init_tensor if lpips is not None else None, loss_callback=loss_cb)
            sampler_cfg = SamplerConfig(
                use_ddim=timestep_respacing.startswith("ddim"), num_classes=1000,
                randomize_class=(randomize_class and class_cond),
                fast_guidance=fast_guidance, dpm_solver=dpm_solver)
            y_init = (torch.zeros((batch_size,), dtype=torch.long, device=dev)
                      if class_cond else None)
            # recorded noise: {"init": [*shape], "steps": [n_steps, *shape]}
            rec = np.load(noise_file) if noise_file else None
            init_noise = rec["init"] if rec is not None and "init" in rec.files else None
            noise_steps = rec["steps"] if rec is not None and "steps" in rec.files else None

            # ---- run meta, checkpoint / resume ----------------------------
            use_remat = _resolve_remat(image_size, batch_size, num_cutouts)
            run_meta = _run_meta(config, skip_timesteps=skip_timesteps,
                                 use_magnitude=use_magnitude, generator=dev.type,
                                 unet_remat=use_remat)
            resume_state = state_sink = None
            if resume_from:
                resume_state = _read_checkpoint(resume_from, run_meta, dev.type)
                use_remat = run_meta["unet_remat"] = resume_state["unet_remat"]
                say(f"Resuming from {resume_from} at segment {resume_state['next_seg']}.")
            if checkpoint_path:
                os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)
                state_sink = functools.partial(_save_state, checkpoint_path,
                                               json.dumps(run_meta, sort_keys=True))

            # ---- the loop -------------------------------------------------
            hold.take()  # a bfloat16 run's prep stays outside the device lock
            pet("compile + first sampling segment")
            say(f"Sampling {diffusion.num_timesteps - skip_timesteps} steps at "
                f"{side_y}x{side_x}px on {dev}")
            request.note(steps=diffusion.num_timesteps - skip_timesteps)
            t0 = time.perf_counter()
            try:
                for step_k, pred_x0, _x_t in sample_loop(
                    diffusion, _model_fn(unet, mesh, cdtype, use_remat), builder,
                    (batch_size, side_y, side_x, 3), gen, sampler_cfg,
                    skip_timesteps=skip_timesteps, init_image=init_tensor,
                    reduce_clip=reduce_clip, progressive_cutout=progressive_cutout,
                    num_cutouts=num_cutouts, save_frequency=save_frequency, y_init=y_init,
                    noise_override=noise_steps, init_noise=init_noise,
                    final_frame_parity=strict_parity, progress_cb=_StepsDone(pet),
                    image_sink=image_sink, state_sink=state_sink, resume=resume_state,
                    mesh=mesh, shared_device=device_lock is not None,
                ):
                    with tracing.span("images.to_host", k=step_k):
                        frames = pred_x0.float().cpu().numpy()
                    for batch_idx in range(batch_size):
                        path = log_image(frames[batch_idx], prefix_path, prompts, step_k,
                                         batch_idx, use_async=async_frames)
                        # the caller's flags, and its time its own, while suspended
                        with hold.suspended(), tracing.detached(request):
                            yield batch_idx, path
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
            hold.release()  # the caller's flags, then the lock
            if async_frames and (failed := flush_frames()):
                print(f"(warning) {failed} asynchronous frame write(s) failed")
            if wandb_run is not None:
                wandb_run.finish()


def _out_of_memory(e: BaseException) -> bool:
    """A device allocation failed: torch.cuda.OutOfMemoryError, or a
    RuntimeError whose text says so (cuDNN's and cuBLAS's own)."""
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e).lower()
