"""The guided sampling step and loop in PyTorch, counterpart of
``cgd_tpu/diffusion/sampler.py``.

One guided step = UNet forward + ``p_mean_variance`` + the gradient of the
guidance loss with respect to x, taken THROUGH the UNet (the fork's
``cond_fn_with_grad``: pred_xstart is on the tape) + a DDIM, ancestral or
DPM-Solver++(2M) update. ``fast_guidance`` takes the gradient through the
blend with x only (no UNet backward). The loop is a plain Python loop over
the static step plan (with the ``reduce_clip`` and ``progressive_cutout``
gating) over the segments of ``segment_plan``, emitting (step,
pred_xstart, x_t) at their save points, starting from an init image noised
to the first step when the leading steps are skipped. After every segment
it can hand its state to a ``state_sink``, and ``resume`` continues a run
from such a state bit for bit (the generator's state travels with x).

``build_step_plan`` and ``segment_plan`` are copies of the JAX package's
pure-Python plan helpers, pinned to the originals by
tests/test_torch_port_step.py.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cgd_tpu_torch.diffusion.gaussian import GaussianDiffusion, PMeanVariance
from cgd_tpu_torch.utils.tracing import span


class StepMeta(NamedTuple):
    """Static description of one sampler step."""

    t: int  # spaced timestep index
    guided: bool  # run CLIP guidance this step? (--reduce-clip gate)
    cutn: int  # cutouts this step (--progressive-cutout)


def build_step_plan(
    num_timesteps: int,
    skip_timesteps: int = 0,
    reduce_clip: bool = False,
    progressive_cutout: bool = False,
    num_cutouts: int = 16,
) -> List[StepMeta]:
    """Resolve the reference's dynamic per-step Python gating into a static
    plan (reference: cgd/cgd.py:157-175).

    Semantics replicated exactly, including the `current_timestep` off-by-skip
    quirk (SURVEY.md §3.1): the reference tracks
    ``current_timestep = T-1 - consumed`` which only equals the sampler's
    actual t when skip_timesteps == 0. ``progress_pct`` below uses the
    reference's bookkeeping, not the true t, for parity.
    """
    total = num_timesteps
    indices = list(range(total - skip_timesteps))[::-1]  # actual sampler t's
    plan: List[StepMeta] = []
    for consumed, t in enumerate(indices):
        # Reference quirk: its `current_timestep` starts at T-1 and decrements
        # per consumed sample; cond_fn for step k sees T-1-k.
        ref_current = total - 1 - consumed
        progress_pct = (total - ref_current) / total
        guided = True
        if reduce_clip and progress_pct < 0.7:
            step_in_phase = int((progress_pct - 0.2) * total)
            if step_in_phase % 4 != 0:
                guided = False
        if progressive_cutout:
            if progress_pct < 0.3:
                cutn = max(4, num_cutouts // 4)
            elif progress_pct < 0.7:
                cutn = max(8, num_cutouts // 2)
            else:
                cutn = num_cutouts
        else:
            cutn = num_cutouts
        plan.append(StepMeta(t=t, guided=guided, cutn=cutn))
    return plan


def segment_plan(
    plan: List[StepMeta],
    save_frequency: int,
    final_frame_parity: bool = True,
    skip_timesteps: int = 0,
) -> Tuple[List[Tuple[int, List[StepMeta]]], set]:
    """Split the static step plan into segments of identical meta
    (guided, cutn), each ending at a save point. Save at consumed-step k
    where k % save_frequency == 0 => segment boundaries *after* each step
    whose index hits the save rule (reference save cadence:
    cgd/cgd.py:176-197). Returns ([(start_index, [StepMeta,...]), ...],
    save_at)."""
    save_at = set()
    for k in range(len(plan)):
        if k % save_frequency == 0:
            save_at.add(k)
    if not final_frame_parity or skip_timesteps == 0:
        save_at.add(len(plan) - 1)

    segments = []
    k = 0
    n = len(plan)
    while k < n:
        seg = [plan[k]]
        j = k + 1
        while (
            j < n
            and plan[j].guided == plan[k].guided
            and plan[j].cutn == plan[k].cutn
            and (j - 1) not in save_at  # previous step was not a save point
        ):
            seg.append(plan[j])
            j += 1
        segments.append((k, seg))
        k = j
    return segments, save_at


# model_fn(x, t_model_float, y) -> model output [B,H,W,2C] f32
ModelFn = Callable[..., torch.Tensor]


class GuidanceFns(NamedTuple):
    """loss_fn(x, out: PMeanVariance, ref_t: int, gen) -> (scalar, log dict);
    grad_transform(grad) -> (grad, log dict)."""

    loss_fn: Callable
    grad_transform: Callable


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    use_ddim: bool
    eta: float = 0.0
    clip_denoised: bool = False
    randomize_class: bool = False
    num_classes: int = 1000
    # not the reference's semantics: the guidance loss sees a detached
    # p_mean_variance output, so its gradient reaches x through the blend
    # x_in = pred_xstart*fac + x*(1-fac) only, and the UNet runs no backward
    # (the classic pre-fork CLIP guidance)
    fast_guidance: bool = False
    # beyond the reference: the DPM-Solver++(2M) update
    # (GaussianDiffusion.dpm_solver2m_step) in place of DDIM / ancestral;
    # deterministic, so eta and use_ddim are ignored
    dpm_solver: bool = False


def make_guided_step(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    guidance: Optional[GuidanceFns],
    cfg: SamplerConfig,
):
    """Returns step(x, t, ref_t, y, gen, noise_override=None, dpm_state=None)
    -> (x_next, pred_xstart, y_next, log), and with ``cfg.dpm_solver``
    (x_next, pred_xstart, y_next, log, x0_guided). ``t`` is the spaced
    timestep and ``ref_t`` the reference-bookkeeping timestep the guidance
    blend's `fac` lookup uses (cgd/cgd.py:177 quirk). ``dpm_state`` =
    (x0_prev, t_prev, first): the previous step's x0_guided, its timestep
    and whether this is the run's first step.

    Random draws come from ``gen``, in this order: the class labels
    (``randomize_class``), the guidance's cutout coordinates, its
    augmentations (``use_augs``), then the step noise (none under
    ``dpm_solver``). ``noise_override`` replaces the step noise after it is
    drawn, so recorded noise leaves every other draw as it was.

    With ``cfg.fast_guidance`` the UNet forward and ``p_mean_variance`` run
    under ``torch.no_grad()`` and the loss is differentiated with respect to
    x through the blend alone: no UNet graph is built or kept."""

    def step(x, t: int, ref_t: int, y, gen: torch.Generator, noise_override=None,
             dpm_state=None):
        if cfg.randomize_class and y is not None:
            y = torch.randint(0, cfg.num_classes, y.shape, generator=gen, device=y.device)
        t_batch = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)

        def forward(x_):
            model_out = model_fn(x_, diffusion.model_time(t_batch), y)
            return diffusion.p_mean_variance(
                model_out, x_, t_batch, clip_denoised=cfg.clip_denoised)

        log = {}
        grad = None
        if guidance is not None:
            if cfg.fast_guidance:
                with span("step.unet"), torch.no_grad():
                    out = forward(x)
            with torch.enable_grad():
                x_ = x.detach().requires_grad_(True)
                if not cfg.fast_guidance:
                    with span("step.unet"):
                        out = forward(x_)
                with span("step.guidance"):
                    loss, log = guidance.loss_fn(x_, out, ref_t, gen)
                with span("step.backward"):
                    (grads,) = torch.autograd.grad(loss, x_)
        else:
            with span("step.unet"), torch.no_grad():
                out = forward(x)

        with span("step.update", ancestral=int(not (cfg.use_ddim or cfg.dpm_solver))):
            if guidance is not None:
                out = PMeanVariance(*(o.detach() for o in out))
                grad, glog = guidance.grad_transform(-grads)  # negative gradient
                log = {**log, **glog}
            if cfg.dpm_solver:
                x0_prev, t_prev, first = dpm_state
                tp_batch = torch.full_like(t_batch, t_prev)
                with torch.no_grad():
                    x_next, x0g = diffusion.dpm_solver2m_step(
                        out, x, t_batch, tp_batch, first, x0_prev, grad)
                return x_next, out.pred_xstart, y, log, x0g
            noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=torch.float32)
            if noise_override is not None:
                noise = noise_override
            with torch.no_grad():
                if cfg.use_ddim:
                    x_next = diffusion.ddim_sample_step(out, x, t_batch, noise, grad, eta=cfg.eta)
                else:
                    x_next = diffusion.p_sample_step(out, x, t_batch, noise, grad)
            return x_next, out.pred_xstart, y, log

    return step


def sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    guidance_builder,
    shape: Tuple[int, ...],
    gen: torch.Generator,
    cfg: SamplerConfig,
    *,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,  # [*shape] in [-1, 1]
    reduce_clip: bool = False,
    progressive_cutout: bool = False,
    num_cutouts: int = 16,
    save_frequency: int = 1,
    y_init: Optional[torch.Tensor] = None,
    noise_override=None,  # [n_steps, *shape]: recorded per-step noise
    init_noise=None,  # [*shape]: recorded starting noise
    final_frame_parity: bool = False,
    progress_cb: Optional[Callable[[int], None]] = None,
    loss_sink=None,
    image_sink=None,
    state_sink=None,
    resume: Optional[dict] = None,
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Run the guided schedule, yielding (step_index, pred_xstart, x_t) at
    the save points: every ``save_frequency`` steps plus the final step
    (under ``final_frame_parity`` with ``skip_timesteps`` > 0 the final
    step is not saved, the reference's quirk). The first
    ``skip_timesteps`` steps are skipped: the loop starts from
    ``q_sample(init_image or zeros, t0, noise)`` at the plan's first step
    t0; an ``init_image`` without a skip is noised to the last step.
    ``reduce_clip`` and ``progressive_cutout`` gate the guidance and the
    cutout count per step (``build_step_plan``); one step function is built
    per distinct (guided, cutn). With ``cfg.dpm_solver`` the loop carries
    the previous step's guided x0 (zeros before the first step, which is
    first-order). ``init_noise`` / ``noise_override`` replace the starting
    and per-step noise after it is drawn from ``gen``, so a replay draws
    everything else as the recorded run did; both are indexed by the
    run's global step.

    The steps run in the segments of ``segment_plan``; after each segment:
    ``loss_sink(seg_start, {name: np.ndarray[n]})`` gets the log scalars of
    its guided steps, ``image_sink(step_ks, noisy, preds)`` each guided
    step's incoming x_t and pred_xstart (numpy, [n, *shape]),
    ``state_sink(next_seg, {"x", "y", "x0p", "generator"})`` the state to
    continue from (numpy; ``generator`` is ``gen.get_state()``, y and x0p
    None where the run has none), called BEFORE the segment's frame is
    yielded so that a consumer killed mid-save still resumes, then
    ``progress_cb(n_steps)``.

    ``resume`` (such a state plus ``"next_seg"``) continues from that
    segment boundary: the loop draws its starting noise as an uninterrupted
    run does, then sets ``gen`` back to the saved state, so the remaining
    segments see the draws the uninterrupted run saw (class labels, cutout
    coordinates, augmentations, step noise, in that order per step) and
    give its frames bit for bit. The JAX package derives each segment's key
    from the seed instead, so its checkpoints carry no generator state."""
    plan = build_step_plan(diffusion.num_timesteps, skip_timesteps, reduce_clip,
                           progressive_cutout, num_cutouts)
    segments, save_at = segment_plan(plan, save_frequency, final_frame_parity, skip_timesteps)
    device = gen.device
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if init_noise is not None:
        x = torch.as_tensor(init_noise, dtype=torch.float32, device=device)
    if skip_timesteps > 0 or init_image is not None:
        base = torch.zeros(shape, device=device) if init_image is None else init_image
        t0 = torch.full((shape[0],), plan[0].t, dtype=torch.long, device=device)
        x = diffusion.q_sample(base.to(device, torch.float32), t0, x)
    y = y_init
    x0p = torch.zeros(shape, device=device) if cfg.dpm_solver else None
    start_seg = 0
    if resume is not None:
        start_seg = int(resume["next_seg"])
        if not 0 <= start_seg <= len(segments):
            raise ValueError(
                f"resume next_seg={start_seg} outside this plan's "
                f"{len(segments)} segments — different run configuration?")
        if start_seg == len(segments):
            warnings.warn(
                "resume checkpoint marks the run complete (next_seg == "
                f"{len(segments)}); nothing to resume — no frames will be "
                "written. The finished frames are in the original run's "
                "output directory.", stacklevel=2)
        if cfg.dpm_solver and resume.get("x0p") is None:
            raise ValueError("resume checkpoint lacks the dpm_solver x0_prev state — "
                             "was it written by a non-dpm run?")
        if not cfg.dpm_solver and resume.get("x0p") is not None:
            raise ValueError(
                "resume checkpoint carries dpm_solver x0_prev state but "
                "cfg.dpm_solver is False — resuming would silently change "
                "the sampling dynamics")
        x = torch.as_tensor(resume["x"], dtype=torch.float32).to(device)
        if resume.get("y") is not None:
            y = torch.as_tensor(resume["y"], dtype=torch.long).to(device)
        if cfg.dpm_solver:
            x0p = torch.as_tensor(resume["x0p"], dtype=torch.float32).to(device)
        gen.set_state(torch.as_tensor(resume["generator"], dtype=torch.uint8).cpu())
    steps = {}  # one step function per distinct (guided, cutn)
    for si, (k0, seg) in enumerate(segments):
        if si < start_seg:
            continue  # done by the checkpointed run
        with span("loop.segment", first=k0, steps=len(seg)):
            logs, noisy, preds = [], [], []
            for k, meta in enumerate(seg, start=k0):
                key = (meta.guided, meta.cutn)
                if key not in steps:
                    guidance = guidance_builder(meta) if meta.guided else None
                    steps[key] = make_guided_step(diffusion, model_fn, guidance, cfg)
                ref_t = diffusion.num_timesteps - 1 - k
                x_in = x
                with span("step", k=k, guided=meta.guided, cutn=meta.cutn):
                    if cfg.dpm_solver:  # deterministic: no step noise
                        x, pred_x0, y, log, x0p = steps[key](
                            x, meta.t, ref_t, y, gen,
                            dpm_state=(x0p, plan[max(k - 1, 0)].t, k == 0))
                    else:
                        nz = None
                        if noise_override is not None:
                            nz = torch.as_tensor(noise_override[k], dtype=torch.float32,
                                                 device=device)
                        x, pred_x0, y, log = steps[key](x, meta.t, ref_t, y, gen,
                                                        noise_override=nz)
                if meta.guided:
                    if loss_sink is not None:
                        logs.append(log)
                    if image_sink is not None:
                        noisy.append(x_in.float().cpu().numpy())
                        preds.append(pred_x0.float().cpu().numpy())
            if loss_sink is not None and logs:
                loss_sink(k0, {name: torch.stack([lg[name] for lg in logs]).float().cpu().numpy()
                               for name in logs[0]})
            if image_sink is not None and noisy:
                image_sink(list(range(k0, k0 + len(noisy))), np.stack(noisy), np.stack(preds))
            if state_sink is not None:
                state_sink(si + 1, {
                    "x": x.cpu().numpy(),
                    "y": None if y is None else y.cpu().numpy(),
                    "x0p": None if x0p is None else x0p.cpu().numpy(),
                    "generator": gen.get_state().numpy(),
                })
        last_k = k0 + len(seg) - 1
        if last_k in save_at:
            yield last_k, pred_x0, x
        if progress_cb is not None:
            progress_cb(len(seg))
