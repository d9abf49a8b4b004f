"""The guided sampling step and loop in PyTorch, counterpart of
``cgd_tpu/diffusion/sampler.py``.

One guided step = UNet forward + ``p_mean_variance`` + the gradient of the
guidance loss with respect to x, taken THROUGH the UNet (the fork's
``cond_fn_with_grad``: pred_xstart is on the tape) + a DDIM or ancestral
update. The loop is a plain Python loop over the static step plan that emits
(step, pred_xstart, x_t) at the save points of ``segment_plan``; it has no
checkpoint/resume yet.

``build_step_plan`` and ``segment_plan`` are copies of the JAX package's
pure-Python plan helpers, pinned to the originals by
tests/test_torch_port_step.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch

from cgd_tpu_torch.diffusion.gaussian import GaussianDiffusion, PMeanVariance


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


def make_guided_step(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    guidance: Optional[GuidanceFns],
    cfg: SamplerConfig,
):
    """Returns step(x, t, ref_t, y, gen, noise_override=None)
    -> (x_next, pred_xstart, y_next, log). ``t`` is the spaced timestep and
    ``ref_t`` the reference-bookkeeping timestep the guidance blend's `fac`
    lookup uses (cgd/cgd.py:177 quirk). Random draws come from ``gen``, in
    the order: class labels, guidance (cutout coords), step noise."""

    def step(x, t: int, ref_t: int, y, gen: torch.Generator, noise_override=None):
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
            with torch.enable_grad():
                x_ = x.detach().requires_grad_(True)
                out = forward(x_)
                loss, log = guidance.loss_fn(x_, out, ref_t, gen)
                (grads,) = torch.autograd.grad(loss, x_)
            out = PMeanVariance(*(o.detach() for o in out))
            grad, glog = guidance.grad_transform(-grads)  # negative gradient
            log = {**log, **glog}
        else:
            with torch.no_grad():
                out = forward(x)

        if noise_override is not None:
            noise = noise_override
        else:
            noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=torch.float32)
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
    num_cutouts: int = 16,
    save_frequency: int = 1,
    y_init: Optional[torch.Tensor] = None,
    noise_override=None,  # [n_steps, *shape]: recorded per-step noise
    init_noise=None,  # [*shape]: recorded starting noise
    final_frame_parity: bool = False,
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Run the guided schedule, yielding (step_index, pred_xstart, x_t) at
    the save points: every ``save_frequency`` steps plus the final step."""
    plan = build_step_plan(diffusion.num_timesteps, num_cutouts=num_cutouts)
    _, save_at = segment_plan(plan, save_frequency, final_frame_parity)
    device = gen.device
    if init_noise is not None:
        x = torch.as_tensor(init_noise, dtype=torch.float32, device=device)
    else:
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    y = y_init
    steps = {}  # one step function per distinct (guided, cutn)
    for k, meta in enumerate(plan):
        key = (meta.guided, meta.cutn)
        if key not in steps:
            guidance = guidance_builder(meta) if meta.guided else None
            steps[key] = make_guided_step(diffusion, model_fn, guidance, cfg)
        nz = None
        if noise_override is not None:
            nz = torch.as_tensor(noise_override[k], dtype=torch.float32, device=device)
        ref_t = diffusion.num_timesteps - 1 - k
        x, pred_x0, y, _ = steps[key](x, meta.t, ref_t, y, gen, noise_override=nz)
        if k in save_at:
            yield k, pred_x0, x
