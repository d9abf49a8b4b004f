"""`cgd` CLI of the port: the flags, spellings and defaults of
``cgd_tpu/cli.py`` (flag-compatible with the reference CLI), mapped onto
``cgd_tpu_torch.api.clip_guided_diffusion``.

    python -m cgd_tpu_torch.cli --prompts "a lighthouse" -size 512 -clip RN50x16 \\
        -cutn 16 -respace ddim25 --weights-mode random

``--device`` defaults to ``cuda`` and nothing falls back to the CPU.
``--mesh`` builds its mesh over the visible devices of that kind (every card;
the one CPU device for ``--device cpu``). ``--weights-mode auto`` (the
default) loads the published checkpoints from ``-ckpts``; the repository
holds no weights and no BPE merge table. Flags the port cannot honour yet
(``-gif`` / ``-mp4``, ``--profile``, ``--log-losses``, ``--checkpoint`` /
``--resume``, ``--stall-timeout``) raise ``NotImplementedError`` naming the
flag; the API refuses W&B by name. ``--dropout`` is accepted and, as in the
JAX package's sampling, never applied.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from cgd_tpu_torch.registry import CLIP_MODEL_NAMES
from cgd_tpu_torch.weights import CACHE_PATH

# flags the port cannot honour yet: argparse dest -> spelling
REFUSED = {
    "save_as_gif": "-gif/--save-as-gif",
    "save_as_video": "-mp4/--save-as-video",
    "profile": "--profile",
    "log_losses": "--log-losses",
    "checkpoint": "--checkpoint",
    "resume": "--resume",
    "stall_timeout": "--stall-timeout",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("--prompts", "-txts", type=str, default="",
                   help="text prompt(s), '|'-separated, each optionally 'text:weight' (negative weights penalize), e.g. 'a forest:0.7|blurry:-0.4'")
    p.add_argument("--image_prompts", "-imgs", type=str, default="",
                   help="image prompt(s), '|'-separated paths/URLs, each optionally 'path:weight'")
    p.add_argument("--image_size", "-size", type=int, default=128,
                   help="output resolution; a checkpoint exists for each of 64, 128, 256, 512")
    p.add_argument("--init_image", "-init", type=str, default="",
                   help="start from this image (noised to the skip point) instead of pure noise")
    p.add_argument("--init_scale", "-is", type=int, default=0,
                   help="weight of the VGG/LPIPS perceptual loss pulling samples toward --init_image")
    p.add_argument("--skip_timesteps", "-skip", type=int, default=0,
                   help="how many leading diffusion steps to skip (used with --init_image)")
    p.add_argument("--prefix", "-dir", default="outputs", type=Path, help="output directory")
    p.add_argument("--checkpoints_dir", "-ckpts", default=CACHE_PATH, type=Path,
                   help="directory where model checkpoints are cached")
    p.add_argument("--batch_size", "-bs", type=int, default=1, help="number of images to sample at once")
    p.add_argument("--clip_guidance_scale", "-cgs", type=float, default=1000,
                   help="strength of the CLIP prompt-matching guidance")
    p.add_argument("--tv_scale", "-tvs", type=float, default=150.0,
                   help="total-variation loss weight (higher = smoother output)")
    p.add_argument("--range_scale", "-rs", type=float, default=50.0,
                   help="range loss weight penalizing pixels outside [-1, 1]")
    p.add_argument("--sat_scale", "-sats", type=float, default=0.0,
                   help="saturation loss weight (mostly useful with ddim respacing)")
    p.add_argument("--seed", "-seed", type=int, default=0, help="PRNG seed for reproducible runs")
    p.add_argument("--save_frequency", "-freq", type=int, default=1, help="write a frame every N steps")
    p.add_argument("--diffusion_steps", "-steps", type=int, default=1000, help="length of the full (pre-respacing) diffusion schedule")
    p.add_argument("--timestep_respacing", "-respace", type=str, default="1000",
                   help="respaced schedule: a step count, 'ddimN', or comma sections")
    p.add_argument("--num_cutouts", "-cutn", type=int, default=16,
                   help="number of random crops CLIP scores per guided step")
    p.add_argument("--cutout_power", "-cutpow", type=float, default=1.0, help="exponent skewing the random crop size distribution")
    p.add_argument("--clip_model", "-clip", type=str, default="ViT-B/32",
                   help=f"clip model name. Should be one of: {CLIP_MODEL_NAMES}")
    p.add_argument("--uncond", "-uncond", action="store_true",
                   help="use the unconditional checkpoints (256px OpenAI / 512px finetune) instead of class-conditional")
    p.add_argument("--noise_schedule", "-sched", default="linear", type=str,
                   help="beta schedule: 'linear' or 'cosine' (note: overrides the checkpoint default)")
    p.add_argument("--dropout", "-drop", default=0.0, type=float,
                   help="UNet dropout rate (sampling applies none)")
    p.add_argument("--device", "-dev", default="cuda", type=str,
                   help="'cuda' (raises without a card) or 'cpu' (the kernels' plain PyTorch versions)")
    p.add_argument("--wandb_project", "-proj", default=None,
                   help="log the run to this Weights & Biases project (not ported: raises)")
    p.add_argument("--wandb_entity", "-ent", default=None,
                   help="W&B team/entity owning the project")
    p.add_argument("--height_offset", "-ht", default=0, type=int, help="extra output height (multiple of the UNet downsample factor)")
    p.add_argument("--width_offset", "-wd", default=0, type=int, help="extra output width (multiple of the UNet downsample factor)")
    p.add_argument("--use_augs", "-augs", action="store_true",
                   help="apply flip/affine/perspective/grayscale augs to guidance cutouts")
    p.add_argument("--use_magnitude", "-mag", action="store_true",
                   help="RMS-clamp the guidance gradient (auto-enabled at 64px)")
    p.add_argument("--quiet", "-q", action="store_true", help="suppress progress output")
    p.add_argument("--save-as-gif", "-gif", action="store_true",
                   help="mux saved frames into a GIF (not ported: raises)")
    p.add_argument("--save-as-video", "-mp4", action="store_true",
                   help="mux saved frames into an MP4 (not ported: raises)")
    p.add_argument("--reduce-clip", "-reduce", action="store_true",
                   help="stage CLIP guidance (skip 20%%, every 4th step to 70%%) to generate faster")
    p.add_argument("--progressive-cutout", "-cutn_skip", action="store_true",
                   help="ramp the cutout count (cutn/4 -> cutn/2 -> cutn) across the schedule")
    p.add_argument("--cached-cutouts", "-cached_cutn", action="store_true",
                   help="sample cutout coordinates once and reuse them every step")
    p.add_argument("--weights-mode", default="auto", choices=["auto", "random"],
                   help="'auto' loads checkpoints (converted once to .npz.cgd); 'random' uses random init")
    p.add_argument("--mesh", default=None, type=str, metavar="SPEC",
                   help="shard the run across every visible card: 'auto' "
                        "(all devices; no-op on one device), 'data=N' (N-way "
                        "batch parallelism, the rest split cutouts + UNet "
                        "height), 'cut=M', or 'data=N,cut=M'. Weights are "
                        "replicated (see cgd_tpu_torch/parallel/mesh.py)")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="activation dtype: bfloat16, or float32 (the f32 kernels, TF32 off; "
                        "with --mesh the split convs on K-halo f32)")
    p.add_argument("--profile", default=None, type=str,
                   help="write a profiler trace to this directory (not ported: raises)")
    p.add_argument("--log-losses", action="store_true",
                   help="print per-step guidance loss lines (not ported: raises)")
    p.add_argument("--fast-guidance", action="store_true",
                   help="guide on a detached denoised prediction (classic pre-fork CLIP "
                        "guidance; skips the UNet backward). NOT reference semantics")
    p.add_argument("--dpm-solver", dest="dpm_solver", action="store_true",
                   help="use the DPM-Solver++(2M) second-order multistep update instead of "
                        "DDIM/ancestral (try ddim50 budgets). Deterministic. NOT reference "
                        "semantics")
    p.add_argument("--checkpoint", default=None, type=str, metavar="PATH",
                   help="save resumable sampling state (not ported: raises)")
    p.add_argument("--resume", default=None, type=str, metavar="PATH",
                   help="resume sampling from a --checkpoint file (not ported: raises)")
    p.add_argument("--stall-timeout", default=0.0, type=float, metavar="SECONDS",
                   help="fail instead of hanging on a stalled device (not ported: nonzero raises)")
    p.add_argument("--no-strict-parity", dest="strict_parity", action="store_false",
                   help="fix reference quirks instead of replicating them")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    defaults = parser.parse_args([])
    for dest, flag in REFUSED.items():
        if getattr(args, dest) != getattr(defaults, dest):
            raise NotImplementedError(f"{flag} is not ported to cgd_tpu_torch yet")
    class_cond = not args.uncond
    prefix_path = args.prefix
    Path(prefix_path).mkdir(exist_ok=True)
    prompts = args.prompts.split("|") if len(args.prompts) > 0 else []
    image_prompts = args.image_prompts.split("|") if len(args.image_prompts) > 0 else []

    from cgd_tpu_torch.api import clip_guided_diffusion

    mesh = None
    if args.mesh:
        from cgd_tpu_torch.parallel.mesh import mesh_from_spec, visible_devices

        mesh = mesh_from_spec(args.mesh, visible_devices(args.device))
        if mesh is None and not args.quiet:
            print("--mesh auto: one device visible; running single-chip")

    cgd_generator = clip_guided_diffusion(
        prompts=prompts,
        image_prompts=image_prompts,
        batch_size=args.batch_size,
        tv_scale=args.tv_scale,
        init_scale=args.init_scale,
        range_scale=args.range_scale,
        sat_scale=args.sat_scale,
        image_size=args.image_size,
        class_cond=class_cond,
        randomize_class=class_cond,
        save_frequency=args.save_frequency,
        clip_guidance_scale=args.clip_guidance_scale,
        cutout_power=args.cutout_power,
        num_cutouts=args.num_cutouts,
        timestep_respacing=args.timestep_respacing,
        seed=args.seed,
        diffusion_steps=args.diffusion_steps,
        skip_timesteps=args.skip_timesteps,
        init_image=args.init_image,
        checkpoints_dir=str(args.checkpoints_dir),
        clip_model_name=args.clip_model,
        noise_schedule=args.noise_schedule,
        dropout=args.dropout,
        device=args.device,
        prefix_path=prefix_path,
        wandb_project=args.wandb_project,
        wandb_entity=args.wandb_entity,
        use_augs=args.use_augs,
        use_magnitude=args.use_magnitude,
        height_offset=args.height_offset,
        width_offset=args.width_offset,
        progress=not args.quiet,
        reduce_clip=args.reduce_clip,
        progressive_cutout=args.progressive_cutout,
        cached_cutouts=args.cached_cutouts,
        weights_mode=args.weights_mode,
        compute_dtype=args.compute_dtype,
        mesh=mesh,
        strict_parity=args.strict_parity,
        fast_guidance=args.fast_guidance,
        dpm_solver=args.dpm_solver,
    )
    list(enumerate(cgd_generator))  # drain the generator


if __name__ == "__main__":
    main()
