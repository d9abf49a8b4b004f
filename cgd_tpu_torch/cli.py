"""`cgd` CLI of the port: the flags, spellings and defaults of
``cgd_tpu/cli.py`` (flag-compatible with the reference CLI), mapped onto
``cgd_tpu_torch.api.clip_guided_diffusion``.

    python -m cgd_tpu_torch.cli --prompts "a lighthouse" -size 512 -clip RN50x16 \\
        -cutn 16 -respace ddim25 --weights-mode random

``--device`` defaults to ``cuda`` and nothing falls back to the CPU.
``--mesh`` builds its mesh over the visible devices of that kind (every card;
the one CPU device for ``--device cpu``). ``--weights-mode auto`` (the
default) loads the published checkpoints from ``-ckpts``; the repository
holds no weights and no BPE merge table. Every flag of the JAX CLI is
honoured: ``-gif`` / ``-mp4`` mux the frames (ffmpeg, else Pillow / OpenCV
where importable; the frames are deleted only when every requested mux
wrote a file), ``--profile DIR`` writes a ``torch.profiler`` Chrome trace
(CPU and CUDA activities) to DIR with the port's spans (``utils/tracing.py``)
on a row of their own, on the trace's clock, ``--log-losses`` prints a line of loss
scalars per guided step, ``--checkpoint`` / ``--resume`` save the sampling
state after every segment and continue from it, and ``--stall-timeout``
exits with code 117 (``utils.watchdog.STALL_EXIT_CODE``, after writing
``<prefix>/stall_report.json``) when no progress is made for that many
seconds, so that a supervisor can restart the run with ``--resume``.
Frames are written on a background thread. ``--dropout`` is accepted and,
as in the JAX package's sampling, never applied.
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from cgd_tpu_torch.registry import CLIP_MODEL_NAMES
from cgd_tpu_torch.utils import tracing
from cgd_tpu_torch.weights import CACHE_PATH

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
                   help="log the run to this Weights & Biases project")
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
                   help="mux saved frames into a GIF (ffmpeg, else Pillow), then delete the frames")
    p.add_argument("--save-as-video", "-mp4", action="store_true",
                   help="mux saved frames into an MP4 (ffmpeg, else OpenCV), then delete the frames")
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
                   help="write a torch.profiler Chrome trace (CPU and CUDA) to this directory")
    p.add_argument("--log-losses", action="store_true",
                   help="print per-step guidance loss lines (costs a device sync per step)")
    p.add_argument("--fast-guidance", action="store_true",
                   help="guide on a detached denoised prediction (classic pre-fork CLIP "
                        "guidance; skips the UNet backward). NOT reference semantics")
    p.add_argument("--dpm-solver", dest="dpm_solver", action="store_true",
                   help="use the DPM-Solver++(2M) second-order multistep update instead of "
                        "DDIM/ancestral (try ddim50 budgets). Deterministic. NOT reference "
                        "semantics")
    p.add_argument("--checkpoint", default=None, type=str, metavar="PATH",
                   help="save resumable sampling state (atomic npz, the generator's state with it) after "
                        "every segment; continue an interrupted run with --resume")
    p.add_argument("--resume", default=None, type=str, metavar="PATH",
                   help="resume sampling from a --checkpoint file (the run flags must match the "
                        "original; the frames equal the uninterrupted run's)")
    p.add_argument("--stall-timeout", default=0.0, type=float, metavar="SECONDS",
                   help="fail instead of hanging forever if the card stops responding: exit with "
                        "code 117 (and write <prefix>/stall_report.json) when no progress happens "
                        "for SECONDS. Set it above the kernels' first build (nvcc, tens of "
                        "seconds). 0 disables. Pairs with --checkpoint/--resume")
    p.add_argument("--no-strict-parity", dest="strict_parity", action="store_false",
                   help="fix reference quirks instead of replicating them")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    class_cond = not args.uncond
    prefix_path = args.prefix
    Path(prefix_path).mkdir(exist_ok=True)
    prompts = args.prompts.split("|") if len(args.prompts) > 0 else []
    image_prompts = args.image_prompts.split("|") if len(args.image_prompts) > 0 else []

    from cgd_tpu_torch.api import clip_guided_diffusion
    from cgd_tpu_torch.utils.watchdog import StallDetector

    mesh = None
    if args.mesh:
        from cgd_tpu_torch.parallel.mesh import mesh_from_spec, visible_devices

        mesh = mesh_from_spec(args.mesh, visible_devices(args.device))
        if mesh is None and not args.quiet:
            print("--mesh auto: one device visible; running single-chip")

    profiler = None
    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        tracing.enable()
        profiler = profile(activities=activities)
        profiler.__enter__()

    stall_dog = StallDetector(
        args.stall_timeout,
        exit_on_stall=True,
        report_path=str(Path(prefix_path) / "stall_report.json"),
    )

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
        async_frames=True,  # the CLI reads frames only after the loop (the muxes)
        log_losses=args.log_losses,
        strict_parity=args.strict_parity,
        fast_guidance=args.fast_guidance,
        dpm_solver=args.dpm_solver,
        checkpoint_path=args.checkpoint,
        resume_from=args.resume,
        stall_pet=stall_dog.pet,
    )
    try:
        with stall_dog:
            list(enumerate(cgd_generator))  # drain the generator
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
            spans = tracing.take()
            tracing.disable()
            Path(args.profile).mkdir(parents=True, exist_ok=True)
            trace_path = Path(args.profile) / "trace.json"
            profiler.export_chrome_trace(str(trace_path))
            tracing.add_to_chrome_trace(trace_path, spans)
            print(f"Profile trace written to {args.profile}")

    from cgd_tpu_torch.io_utils.images import clean_and_combine_prompts
    from cgd_tpu_torch.io_utils.video import create_gif_ffmpeg, create_video_ffmpeg

    # The reference deletes the frames even when the mux fails (cgd/cgd.py:415-430);
    # that loses every output on a machine without ffmpeg, so, as the JAX
    # CLI does, they are deleted only when every requested mux wrote a file.
    delete_frames = args.save_as_gif or args.save_as_video
    for batch_idx in range(args.batch_size):
        muxed = []
        if args.save_as_gif:
            muxed.append(create_gif_ffmpeg(prefix_path, prompts, batch_idx, delete_frames=False))
        if args.save_as_video:
            muxed.append(create_video_ffmpeg(prefix_path, prompts, batch_idx, delete_frames=False))
        if delete_frames and all(m is not None for m in muxed):
            io_safe_prompts = clean_and_combine_prompts(prefix_path, prompts, batch_idx)
            image_files = sorted(glob.glob(f"{io_safe_prompts}/*.png"))
            for f in image_files:
                Path(f).unlink()
            if Path(io_safe_prompts).is_dir() and not list(Path(io_safe_prompts).iterdir()):
                Path(io_safe_prompts).rmdir()
            print(f"Deleted {len(image_files)} frame(s)")


if __name__ == "__main__":
    main()
