"""Offline guided-quality proxy for the sampler's options, on the port's own
``sample_loop``. Counterpart of the JAX package's
``tools/guided_quality_proxy.py``: the same analytic system, towers,
arms, metrics and tables.

    python -m cgd_tpu_torch.tools.guided_quality_proxy                 # both tables, on the card
    python -m cgd_tpu_torch.tools.guided_quality_proxy --device cpu

Everything is analytic but the element under test, and the arms run
through the product's machinery (``diffusion.sampler.sample_loop``: the
step plan with its reduce-clip gating and progressive cutout counts, the
reference's ref_t bookkeeping, the fast-guidance detach, the
DPM-Solver++(2M) update):

- the model is the exact eps-prediction of x0 ~ N(MU, S2 I), so every
  deviation is the solver's or the schedule's;
- the guidance's "CLIP" is a fixed random nonlinear tower (two stride-2
  3x3 convs with tanh, a global mean pool, a linear head, L2
  normalisation; ``RandomState(11)`` weights, the JAX tower's), whose
  spherical distance to a unit target of the blend x_in = pred_xstart fac
  + x (1 - fac) is the loss (times CGS). Its convs pad as XLA's "SAME"
  does at stride 2: nothing before and one row / column after on an even
  side.

1. The solver table (``compute_table``): the whole-image loss,
   deterministic DDIM eta = 0 dynamics, the truth the full-gradient guided
   ODE at 1000 steps; arms ddim250 / ddim50 / dpm@50 / dpm@25 / fast@250 /
   fast@50, each against the truth's endpoint.
2. The flag table (``compute_flag_table``): the loss over real cutouts
   (``guidance.cutouts.make_cutouts``) of x_in, at ddim250, each arm one of
   the reference's speed flags (--reduce-clip, which also skips the first
   20% of the steps; --progressive-cutout; --cached-cutouts), against the
   all-flags-off endpoint. The cutout coordinates of a step are the JAX
   tool's: ``sample_cutout_coords`` under the key
   ``fold_in(PRNGKey(COORD_SEED), ref_t)`` (``step_coords``; ref_t 0 for
   cached cutouts), so every arm sees the same coordinates at the same
   step, and the held-out set is drawn under ``PRNGKey(EVAL_SEED)``. Both
   come from ``jax_prng``, ``jax.random``'s generator in numpy, bit for
   bit, so this table is the JAX tool's on the same coordinates.

Metrics: ``rms_vs_truth`` / ``rms_vs_baseline`` (RMS distance of the final
sample to the experiment's reference endpoint), ``clip_objective`` (the
tower's spherical distance at the final sample; the flag table's over a
fixed evaluation cutout set), ``prior_fit`` (mean squared Mahalanobis
deviation under N(MU, S2)). Runs in f32 on ``--device`` (cuda by default;
it raises without a card), with TF32 off.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from cgd_tpu_torch.api import _TF32Off, resolve_device
from cgd_tpu_torch.diffusion.gaussian import make_diffusion
from cgd_tpu_torch.diffusion.sampler import GuidanceFns, SamplerConfig, sample_loop
from cgd_tpu_torch.guidance.cutouts import CutoutSpec, make_cutouts
from cgd_tpu_torch.tools import jax_prng

MU, S2 = 0.3, 0.25
STEPS = 1000
SHAPE = (4, 16, 16, 3)  # 4 independent noise seeds
CGS = 40.0  # strong enough that guidance visibly moves the endpoint
CUT_SIZE = 8
NUM_CUTOUTS = 16  # the reference's default; progressive phases 4 -> 8 -> 16
COORD_SEED = 123
EVAL_SEED = 999


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# toy nonlinear CLIP tower
# ---------------------------------------------------------------------------

def _conv_same_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """XLA's ``conv_general_dilated(x, w, (2, 2), "SAME")`` on NHWC x and
    HWIO w: pad (total // 2, total - total // 2) per side of each axis,
    total = max((ceil(n / 2) - 1) * 2 + 3 - n, 0), then an unpadded stride-2
    conv."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad's order: W, then H
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    h = F.pad(x, (0, 0, *pads))
    return F.conv2d(h.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)


def build_tower(device) -> tuple:
    """(embed, target): the fixed random conv/tanh tower [N, H, W, 3] ->
    L2-normalised [N, 16] (fully convolutional, global mean pool: it embeds
    whole images and 8x8 cutouts alike) and its unit target, from the JAX
    tower's ``RandomState(11)`` draws in its order."""
    rs = np.random.RandomState(11)
    w1 = (rs.randn(3, 3, 3, 16) / np.sqrt(27.0)).astype(np.float32)
    w2 = (rs.randn(3, 3, 16, 32) / np.sqrt(144.0)).astype(np.float32)
    wh = (rs.randn(32, 16) / np.sqrt(32.0)).astype(np.float32)
    target = rs.randn(16).astype(np.float32)
    target /= np.linalg.norm(target)
    w1, w2, wh, tgt = (torch.from_numpy(a).to(device) for a in (w1, w2, wh, target))

    def embed(x):
        h = torch.tanh(_conv_same_s2(x, w1))
        h = torch.tanh(_conv_same_s2(h, w2))
        emb = h.mean(dim=(1, 2)) @ wh
        return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-8)

    return embed, tgt


def spherical(emb: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(2.0 * torch.arcsin(((emb - target).norm(dim=-1) / 2.0).clamp(0.0, 1.0)))


def build_model_fn(device) -> Callable:
    """The exact eps-prediction for x0 ~ N(MU, S2 I) at the model's (1000
    step) timestep."""
    d_full = make_diffusion(STEPS, "linear", None, learn_sigma=False)
    abar = torch.as_tensor(np.asarray(d_full.coeffs.alphas_cumprod, np.float32), device=device)

    def model_fn(x, t_model, y):
        a = abar[t_model.long()].reshape(-1, *(1,) * (x.ndim - 1))
        post = ((1.0 - a) * MU + torch.sqrt(a) * S2 * x) / ((1.0 - a) + a * S2)
        return (x - torch.sqrt(a) * post) / torch.sqrt((1.0 - a).clamp_min(1e-12))

    return model_fn


# ---------------------------------------------------------------------------
# guidance builders (the sampler's GuidanceFns contract)
# ---------------------------------------------------------------------------

def _blend(diffusion, x, out, ref_t: int):
    fac = np.asarray(diffusion.sqrt_one_minus_alphas_cumprod, np.float32)[ref_t]
    return out.pred_xstart * float(fac) + x * float(np.float32(1.0) - fac)


def make_solver_builder(diffusion, embed, target):
    """The whole-image toy-CLIP loss (the solver table: no cutouts)."""

    def builder(meta):
        def loss_fn(x, out, ref_t, gen):
            return CGS * spherical(embed(_blend(diffusion, x, out, ref_t)), target).sum(), {}

        return GuidanceFns(loss_fn, lambda g: (g, {}))

    return builder


def cutout_coords(key, cutn: int, side: int = SHAPE[1]):
    """The JAX package's ``sample_cutout_coords(key, cutn, side, side,
    CUT_SIZE)`` on a ``jax_prng`` key (size = floor(u (max - min) + min),
    offsets uniform integers in [0, side - size]): (offset_x, offset_y,
    size), f32."""
    k_size, k_x, k_y = jax_prng.split(key, 3)
    lo = np.float32(min(side, CUT_SIZE))
    size = np.floor(jax_prng.uniform(k_size, cutn) * (np.float32(side) - lo) + lo)
    ox = np.floor(jax_prng.uniform(k_x, cutn) * (np.float32(side) - size + np.float32(1.0)))
    oy = np.floor(jax_prng.uniform(k_y, cutn) * (np.float32(side) - size + np.float32(1.0)))
    return ox, oy, size


def step_coords(ref_t: int, cutn: int, side: int = SHAPE[1], seed: int = COORD_SEED):
    """The cutout coordinates of step ref_t, as the JAX tool draws them:
    ``cutout_coords`` under ``fold_in(PRNGKey(seed), ref_t)``."""
    return cutout_coords(jax_prng.fold_in(jax_prng.prng_key(seed), ref_t), cutn, side)


def make_flag_builder(diffusion, embed, target, cached_cutouts: bool, coords=step_coords):
    """The cutout toy-CLIP loss (the flag table): meta.cutn real cutouts of
    x_in, the coordinates ``coords(ref_t, cutn)`` (fresh per step) or
    ``coords(0, cutn)`` (cached)."""

    def builder(meta):
        def loss_fn(x, out, ref_t, gen):
            c = coords(0 if cached_cutouts else ref_t, meta.cutn)
            spec = CutoutSpec(*(torch.from_numpy(np.asarray(a)).to(x.device) for a in c))
            cuts = make_cutouts(_blend(diffusion, x, out, ref_t), spec, CUT_SIZE)
            return CGS * spherical(embed(cuts), target).mean() * SHAPE[0], {}

        return GuidanceFns(loss_fn, lambda g: (g, {}))

    return builder


# ---------------------------------------------------------------------------
# arms, through the real sample_loop
# ---------------------------------------------------------------------------

def run_arm(n_steps: int, mode: str, model_fn, builder_for, x_start, *, device,
            reduce_clip: bool = False, progressive_cutout: bool = False,
            cached_cutouts: bool = False, num_cutouts: int = 1) -> np.ndarray:
    """mode: 'ddim' | 'dpm' | 'fast'. The final sample [B, H, W, C]."""
    d = make_diffusion(STEPS, "linear", f"ddim{n_steps}", learn_sigma=False)
    cfg = SamplerConfig(use_ddim=True, fast_guidance=mode == "fast", dpm_solver=mode == "dpm")
    skip = d.num_timesteps // 5 if reduce_clip else 0  # the reference's 20% skip
    final = None
    off = _TF32Off()
    off.enter()
    try:
        for _k, _pred, x in sample_loop(
                d, model_fn, builder_for(d, cached_cutouts), SHAPE,
                torch.Generator(device).manual_seed(0), cfg, skip_timesteps=skip,
                reduce_clip=reduce_clip, progressive_cutout=progressive_cutout,
                num_cutouts=num_cutouts, save_frequency=10 ** 9,
                init_noise=np.asarray(x_start)):
            final = x
    finally:
        off.exit()
    return final.cpu().numpy()


def _metrics(final, ref_endpoint, objective) -> Dict[str, float]:
    return {
        "rms_vs_truth": float(np.sqrt(np.mean((final - ref_endpoint) ** 2))),
        "clip_objective": float(objective(final)),
        "prior_fit": float(np.mean((final - MU) ** 2 / S2)),
    }


def x_start() -> np.ndarray:
    return np.random.RandomState(5).randn(*SHAPE).astype(np.float32)


SOLVER_ARMS = [
    ("ddim250 (reference default)", 250, "ddim"),
    ("ddim50", 50, "ddim"),
    ("dpm@50 (--dpm-solver)", 50, "dpm"),
    ("dpm@25", 25, "dpm"),
    ("fast@250 (--fast-guidance)", 250, "fast"),
    ("fast@50 (--fast-guidance)", 50, "fast"),
]
FLAG_ARMS = [
    ("baseline ddim250 (flags off)", {}),
    ("--reduce-clip", {"reduce_clip": True}),
    ("--progressive-cutout", {"progressive_cutout": True}),
    ("--cached-cutouts", {"cached_cutouts": True}),
    ("all three flags", {"reduce_clip": True, "progressive_cutout": True,
                         "cached_cutouts": True}),
]


def solver_parts(device):
    """(model_fn, builder_for, objective) of the solver table on ``device``."""
    model_fn = build_model_fn(device)
    embed, target = build_tower(device)

    def builder_for(d, cached):
        return make_solver_builder(d, embed, target)

    def objective(final):
        with torch.no_grad():
            return float(spherical(embed(torch.from_numpy(final).to(device)), target).mean())

    return model_fn, builder_for, objective


def compute_table(device="cuda") -> Dict[str, Dict[str, float]]:
    """The solver table (``SOLVER_ARMS`` and the truth, ddim1000)."""
    dev = resolve_device(device)
    model_fn, builder_for, objective = solver_parts(dev)
    xs = x_start()
    log("computing guided truth (ddim1000, full gradient)...")
    truth = run_arm(1000, "ddim", model_fn, builder_for, xs, device=dev)
    table = {}
    for name, n, mode in SOLVER_ARMS:
        log(f"running {name} ...")
        table[name] = _metrics(run_arm(n, mode, model_fn, builder_for, xs, device=dev), truth,
                               objective)
    table["truth (ddim1000)"] = _metrics(truth, truth, objective)
    return table


def compute_flag_table(device="cuda") -> Dict[str, Dict[str, float]]:
    """The flag table (``FLAG_ARMS`` at ddim250, against the first)."""
    dev = resolve_device(device)
    model_fn = build_model_fn(dev)
    embed, target = build_tower(dev)

    def builder_for(d, cached):
        return make_flag_builder(d, embed, target, cached)

    # one evaluation cutout set for every arm, under PRNGKey(EVAL_SEED) itself
    eval_spec = CutoutSpec(*(torch.from_numpy(a).to(dev) for a in cutout_coords(
        jax_prng.prng_key(EVAL_SEED), NUM_CUTOUTS)))

    def objective(final):
        with torch.no_grad():
            cuts = make_cutouts(torch.from_numpy(final).to(dev), eval_spec, CUT_SIZE)
            return float(spherical(embed(cuts), target).mean())

    xs = x_start()
    table, baseline = {}, None
    for name, flags in FLAG_ARMS:
        log(f"running flag arm: {name} ...")
        final = run_arm(250, "ddim", model_fn, builder_for, xs, device=dev,
                        num_cutouts=NUM_CUTOUTS, **flags)
        if baseline is None:
            baseline = final
        m = _metrics(final, baseline, objective)
        m["rms_vs_baseline"] = m.pop("rms_vs_truth")
        table[name] = m
    return table


def print_table(table, dist_key) -> None:
    w = max(len(k) for k in table)
    print(f"| {'arm':<{w}} | {dist_key} | clip_objective | prior_fit |")
    print(f"|{'-' * (w + 2)}|{'-' * (len(dist_key) + 2)}|----------------|-----------|")
    for name, m in table.items():
        print(f"| {name:<{w}} | {m[dist_key]:<{len(dist_key)}.4f} "
              f"| {m['clip_objective']:<14.4f} | {m['prior_fit']:<9.3f} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    print_table(compute_table(args.device), "rms_vs_truth")
    print()
    print_table(compute_flag_table(args.device), "rms_vs_baseline")


if __name__ == "__main__":
    main()
