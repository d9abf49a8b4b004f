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
from such a state bit for bit (the generator's state travels with x). On
one card each step function is captured as a CUDA graph after its first
eager run and replayed from then on (``_StepGraph``), bit for bit.

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


class Blend(NamedTuple):
    """The guidance blend of one step, x_in = pred_xstart * fac + x * rest,
    fac = sqrt(1 - abar[ref_t]) (cgd/cgd.py:177): ``fac`` and ``rest`` = 1 -
    fac, both rounded in float32 on the host, are 0-d float32 tensors on the
    step's device, filled before the step runs, so that a replayed step
    reads this step's values. ``ref_t`` is the host's index: a loss that
    reads it needs the host every step (``GuidanceFns.host_reads``)."""

    ref_t: int
    fac: torch.Tensor
    rest: torch.Tensor


class GuidanceFns(NamedTuple):
    """loss_fn(x, out: PMeanVariance, blend: Blend, gen) -> (scalar, log dict);
    grad_transform(grad) -> (grad, log dict). ``host_reads``: the step needs
    the host inside it (a callback that reads the losses as floats, data
    made on the host each step), so it is never replayed from a CUDA
    graph."""

    loss_fn: Callable
    grad_transform: Callable
    host_reads: bool = False


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


class GuidedStep:
    """step(x, t, ref_t, y, gen, noise_override=None, dpm_state=None) ->
    (x_next, pred_xstart, y_next, log), and with ``cfg.dpm_solver``
    (x_next, pred_xstart, y_next, log, x0_guided). ``t`` is the spaced
    timestep and ``ref_t`` the reference-bookkeeping timestep the guidance
    blend's `fac` lookup uses (cgd/cgd.py:177 quirk). ``dpm_state`` =
    (x0_prev, t_prev, first): the previous step's x0_guided, its timestep
    and whether this is the run's first step.

    The step's per-step values live in device tensors of the step's own,
    filled in place before each call (``inputs``: t and t_prev with
    ``fill_``, the blend's ``Blend.fac`` / ``rest``), and ``core`` is the
    step over tensors alone, so that a CUDA graph of ``core``
    (``_StepGraph``) replays it at every step.

    Random draws come from ``gen``, in this order: the class labels
    (``randomize_class``), the guidance's cutout coordinates, its
    augmentations (``use_augs``), then the step noise (none under
    ``dpm_solver``). ``noise_override`` replaces the step noise after it is
    drawn, so recorded noise leaves every other draw as it was.

    With ``cfg.fast_guidance`` the UNet forward and ``p_mean_variance`` run
    under ``torch.no_grad()`` and the loss is differentiated with respect to
    x through the blend alone: no UNet graph is built or kept."""

    def __init__(self, diffusion: GaussianDiffusion, model_fn: ModelFn,
                 guidance: Optional[GuidanceFns], cfg: SamplerConfig):
        self.diffusion, self.model_fn, self.guidance, self.cfg = diffusion, model_fn, guidance, cfg
        self._sqrt_om = np.asarray(diffusion.sqrt_one_minus_alphas_cumprod, np.float32)
        self._bufs = None  # (t, t_prev, fac, rest)

    @property
    def host_reads(self) -> bool:
        return self.guidance is not None and self.guidance.host_reads

    def inputs(self, x, t: int, ref_t: int, t_prev: int):
        """The step's t, t_prev ([B] long) and blend, filled in place (made
        anew for another batch or device)."""
        b, dev = x.shape[0], x.device
        if self._bufs is None or self._bufs[0].shape[0] != b or self._bufs[0].device != dev:
            self._bufs = (torch.empty(b, dtype=torch.long, device=dev),
                          torch.empty(b, dtype=torch.long, device=dev),
                          torch.empty((), dtype=torch.float32, device=dev),
                          torch.empty((), dtype=torch.float32, device=dev))
        t_batch, tp_batch, fac, rest = self._bufs
        t_batch.fill_(t)
        tp_batch.fill_(t_prev)
        f = self._sqrt_om[ref_t]  # f32, as the JAX blend
        fac.fill_(float(f))
        rest.fill_(float(np.float32(1.0) - f))
        return t_batch, tp_batch, Blend(ref_t, fac, rest)

    def __call__(self, x, t: int, ref_t: int, y, gen: torch.Generator, noise_override=None,
                 dpm_state=None):
        x0_prev, t_prev, first = dpm_state if dpm_state is not None else (None, t, False)
        t_batch, tp_batch, blend = self.inputs(x, t, ref_t, t_prev)
        return self.core(x, t_batch, blend, y, gen, noise_override, x0_prev, tp_batch, first)

    def core(self, x, t_batch, blend: Blend, y, gen: torch.Generator, noise_override, x0_prev,
             tp_batch, first: bool):
        diffusion, guidance, cfg = self.diffusion, self.guidance, self.cfg
        if cfg.randomize_class and y is not None:
            y = torch.randint(0, cfg.num_classes, y.shape, generator=gen, device=y.device)

        def forward(x_):
            model_out = self.model_fn(x_, diffusion.model_time(t_batch), y)
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
                    loss, log = guidance.loss_fn(x_, out, blend, gen)
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


def make_guided_step(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    guidance: Optional[GuidanceFns],
    cfg: SamplerConfig,
) -> GuidedStep:
    """The guided step (``GuidedStep``), run eagerly at each call."""
    return GuidedStep(diffusion, model_fn, guidance, cfg)


def _captures(device: torch.device, mesh, host_reads: bool, shared_device: bool) -> bool:
    """The graph rule: a step is captured as a CUDA graph and replayed when
    it runs on one CUDA device, nothing inside it needs the host and no
    other thread works on the device meanwhile. It runs eagerly every time
    on the CPU, over a ``mesh`` (the model and the guidance split over its
    devices), where its guidance reads on the host
    (``GuidanceFns.host_reads``: a loss callback) and on a
    ``shared_device``: another thread's allocation, copy or
    synchronization during a capture fails both (the serving daemon
    prepares the next request on the card while one samples)."""
    return device.type == "cuda" and mesh is None and not host_reads and not shared_device


def _copied(out):
    """The step's outputs, out of the graph's static buffers."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return out


class _StepGraph:
    """A ``GuidedStep`` (its key ``key``) as one CUDA graph of its ``core``,
    captured at the first call and replayed at every call; the same
    signature and results as the step, bit for bit.

    The inputs that change per step are static tensors: t, t_prev and the
    blend (the step's own, filled by ``GuidedStep.inputs``), and copies of
    x, y, the noise override and x0_prev, refilled before each replay.
    ``gen`` is registered with the graph, so each replay draws the class
    labels, cutout coordinates, augmentations and step noise from the
    generator's offset at that time and advances it as the eager step does.
    The outputs are static tensors too, and each call returns copies of
    them. The graphs of one ``sample_loop`` call share the memory ``pool``;
    nothing of them outlives the call.

    The kernels' launch counters (``kernels.launch_counters``) count at a
    launch from the host; a replay launches what its capture recorded and
    adds those counts, so they read as under the eager step."""

    def __init__(self, step: GuidedStep, key, gen: torch.Generator, pool):
        self.step, self.key, self.gen, self.pool = step, key, gen, pool
        self.graph = None

    def __call__(self, x, t: int, ref_t: int, y, gen: torch.Generator, noise_override=None,
                 dpm_state=None):
        x0_prev, t_prev, first = dpm_state if dpm_state is not None else (None, t, False)
        t_batch, tp_batch, blend = self.step.inputs(x, t, ref_t, t_prev)
        if first or gen is not self.gen or self.graph is not None and t_batch is not self.t:
            raise ValueError("a graphed step runs one batch on one device from one generator, "
                             "and not a run's first step")
        if self.graph is None:
            self.static = [None if v is None else v.clone() for v in (x, y, noise_override,
                                                                       x0_prev)]
            self._capture(t_batch, blend, tp_batch)
        else:
            for buf, v in zip(self.static, (x, y, noise_override, x0_prev)):
                if buf is not None:
                    buf.copy_(v)
        self.graph.replay()
        for counter, name, n in self.launches:
            counter[name] += n
        return tuple(_copied(o) for o in self.outs)

    def _capture(self, t_batch, blend: Blend, tp_batch) -> None:
        from cgd_tpu_torch.kernels import launch_counters

        guided, cutn = self.key
        x, y, noise, x0_prev = self.static
        before = {(id(c), k): n for c in launch_counters() for k, n in c.items()}
        with span("step.capture", guided=guided, cutn=cutn):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.gen)
            with torch.cuda.graph(graph, pool=self.pool):
                self.outs = self.step.core(x, t_batch, blend, y, self.gen, noise, x0_prev,
                                           tp_batch, False)
        # what the capture counted is launched at each replay, and counted there
        self.launches = [(c, k, n - before.get((id(c), k), 0)) for c in launch_counters()
                         for k, n in c.items() if n > before.get((id(c), k), 0)]
        for counter, name, n in self.launches:
            counter[name] -= n
        self.graph, self.t = graph, t_batch


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
    image_sink=None,
    state_sink=None,
    resume: Optional[dict] = None,
    mesh=None,
    shared_device: bool = False,
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
    ``image_sink(step_ks, noisy, preds)`` gets each guided step's incoming
    x_t and pred_xstart (numpy, [n, *shape]),
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
    from the seed instead, so its checkpoints carry no generator state.

    On one CUDA device (``_captures``: no ``mesh``, the model and guidance
    split over its devices, no guidance that reads on the host, and not a
    ``shared_device``, which other threads use during the loop) each key's
    first step runs eagerly, its second is captured as a CUDA graph
    (``_StepGraph``), and that graph is replayed for the key's every later
    step: the same kernels, draws and results, bit for bit, without the
    host's dispatch of each operation. The graphs are freed when the call
    ends."""
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
    steps = {}  # one step function per distinct (guided, cutn), and then its graph
    graph_next = {}  # the keys whose next step is captured (the rule, asked once a key)
    pool = None  # the memory pool of this call's graphs
    for si, (k0, seg) in enumerate(segments):
        if si < start_seg:
            continue  # done by the checkpointed run
        with span("loop.segment", first=k0, steps=len(seg)):
            noisy, preds = [], []
            for k, meta in enumerate(seg, start=k0):
                key = (meta.guided, meta.cutn)
                step = steps.get(key)
                if step is None:  # a key's first step runs eagerly, the run's first among them
                    guidance = guidance_builder(meta) if meta.guided else None
                    step = steps[key] = make_guided_step(diffusion, model_fn, guidance, cfg)
                    graph_next[key] = _captures(device, mesh, step.host_reads, shared_device)
                elif graph_next.pop(key, False):
                    pool = torch.cuda.graph_pool_handle() if pool is None else pool
                    step = steps[key] = _StepGraph(step, key, gen, pool)
                ref_t = diffusion.num_timesteps - 1 - k
                x_in = x
                with span("step", k=k, guided=meta.guided, cutn=meta.cutn,
                          graph=int(isinstance(step, _StepGraph))):
                    if cfg.dpm_solver:  # deterministic: no step noise
                        x, pred_x0, y, _log, x0p = step(
                            x, meta.t, ref_t, y, gen,
                            dpm_state=(x0p, plan[max(k - 1, 0)].t, k == 0))
                    else:
                        nz = None
                        if noise_override is not None:
                            nz = torch.as_tensor(noise_override[k], dtype=torch.float32,
                                                 device=device)
                        x, pred_x0, y, _log = step(x, meta.t, ref_t, y, gen, noise_override=nz)
                if meta.guided and image_sink is not None:
                    noisy.append(x_in.float().cpu().numpy())
                    preds.append(pred_x0.float().cpu().numpy())
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
