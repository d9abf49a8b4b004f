"""Gaussian diffusion process in PyTorch, counterpart of
``cgd_tpu/diffusion/gaussian.py``: the (respaced) schedule, ``q_sample``, ``p_mean_variance``
with the learned-sigma split, and the DDIM, ancestral and DPM-Solver++(2M)
steps with the fork's gradient conditioning. Images are NHWC float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from cgd_tpu_torch.diffusion.respace import space_timesteps
from cgd_tpu_torch.diffusion.schedules import ScheduleCoefficients, get_named_beta_schedule


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor
    eps: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """A (possibly respaced) diffusion process; ``coeffs`` are over the
    spaced process, ``timestep_map`` maps spaced index -> original step."""

    coeffs: ScheduleCoefficients
    timestep_map: np.ndarray  # int32 [S]
    original_num_steps: int
    rescale_timesteps: bool = False
    learn_sigma: bool = True
    # (id(array), device) -> f32 device copy of one of the arrays above
    _device_copies: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def _on(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        """A device copy of one of this diffusion's (small, immutable) schedule
        arrays, made once, so the sampling loop issues no host-to-device
        copies (each of which would wait for the device) per step."""
        key = (id(arr), str(device))
        hit = self._device_copies.get(key)
        if hit is None:
            hit = torch.as_tensor(np.asarray(arr, np.float32), device=device)
            self._device_copies[key] = hit
        return hit

    def _bcast(self, arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """arr[t] for a [B] index tensor, right-padded for NHWC broadcast (f32)."""
        vals = self._on(arr, t.device)[t]
        return vals.reshape(vals.shape + (1,) * (ndim - vals.ndim))

    @functools.cached_property
    def fixed_large_variance(self) -> np.ndarray:
        """FIXED_LARGE's variance (the non-learned sigma): betas, with
        posterior_variance[1] at t = 0."""
        c = self.coeffs
        if len(c.betas) > 1:
            return np.append(c.posterior_variance[1], c.betas[1:])
        return c.posterior_variance

    @property
    def num_timesteps(self) -> int:
        return self.coeffs.num_timesteps

    @property
    def sqrt_one_minus_alphas_cumprod(self) -> np.ndarray:
        return self.coeffs.sqrt_one_minus_alphas_cumprod

    def model_time(self, t: torch.Tensor) -> torch.Tensor:
        """Spaced index -> value fed to the model's timestep embedding."""
        mapped = self._on(self.timestep_map, t.device)[t]
        if self.rescale_timesteps:
            return mapped * (1000.0 / self.original_num_steps)
        return mapped

    def q_sample(self, x_start, t, noise):
        """Diffuse x_start to step t: sqrt(abar_t) x_start + sqrt(1 - abar_t) noise."""
        c = self.coeffs
        nd = x_start.dim()
        return (self._bcast(c.sqrt_alphas_cumprod, t, nd) * x_start
                + self._bcast(c.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def predict_xstart_from_eps(self, x, t, eps):
        c = self.coeffs
        nd = x.dim()
        return (self._bcast(c.sqrt_recip_alphas_cumprod, t, nd) * x
                - self._bcast(c.sqrt_recipm1_alphas_cumprod, t, nd) * eps)

    def predict_eps_from_xstart(self, x, t, x0):
        c = self.coeffs
        nd = x.dim()
        return ((self._bcast(c.sqrt_recip_alphas_cumprod, t, nd) * x - x0)
                / self._bcast(c.sqrt_recipm1_alphas_cumprod, t, nd))

    def q_posterior_mean(self, x_start, x_t, t):
        c = self.coeffs
        nd = x_t.dim()
        return (self._bcast(c.posterior_mean_coef1, t, nd) * x_start
                + self._bcast(c.posterior_mean_coef2, t, nd) * x_t)

    def p_mean_variance(self, model_output, x, t, clip_denoised: bool = False) -> PMeanVariance:
        """Split the learned-sigma output, predict x0, form the posterior.
        model_output: [B,H,W,2C] if learn_sigma else [B,H,W,C]; x: [B,H,W,C]."""
        c = self.coeffs
        nd = x.dim()
        ch = x.shape[-1]
        if self.learn_sigma:
            eps = model_output[..., :ch]
            var_logits = model_output[..., ch:]
            min_log = self._bcast(c.posterior_log_variance_clipped, t, nd)
            max_log = self._bcast(c.log_betas, t, nd)
            frac = (var_logits.float() + 1.0) / 2.0
            log_variance = frac * max_log + (1.0 - frac) * min_log
            variance = torch.exp(log_variance)
        else:
            eps = model_output
            variance = self._bcast(self.fixed_large_variance, t, nd) * torch.ones_like(x)
            log_variance = torch.log(variance.clamp_min(1e-20))
        eps = eps.float()
        pred_xstart = self.predict_xstart_from_eps(x, t, eps)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean = self.q_posterior_mean(pred_xstart, x, t)
        return PMeanVariance(mean, variance, log_variance, pred_xstart, eps)

    def p_sample_step(self, out: PMeanVariance, x, t, noise, cond_grad=None):
        """Ancestral step; the fork's condition_mean_with_grad:
        new_mean = mean + variance * grad."""
        mean = out.mean
        if cond_grad is not None:
            mean = mean + out.variance * cond_grad.float()
        nonzero = (t != 0).float().reshape((-1,) + (1,) * (x.dim() - 1))
        return mean + nonzero * torch.exp(0.5 * out.log_variance) * noise

    def dpm_solver2m_step(self, out: PMeanVariance, x, t, t_prev, first: bool, x0_prev,
                          cond_grad=None):
        """DPM-Solver++(2M) multistep update (data prediction, deterministic;
        Lu et al. 2022, the multistep form of eq. (4.2) / (4.3)). Guidance
        enters as in ``ddim_sample_step`` (eps' = eps - sqrt(1-abar) grad,
        x0 re-predicted from eps'); then, with lam = log(alpha / sigma),
        h = lam_s - lam_t toward the level s below t and
        r = (lam_t - lam_prev) / h:

            D   = (1 + c) x0_t - c x0_prev,   c = min(1 / (2r), 0.5)
            x_s = (sigma_s / sigma_t) x_t - alpha_s (e^{-h} - 1) D

        The 0.5 clamp keeps the extrapolation from overshooting where the
        respaced grid's log-SNR gaps grow toward t = 0. ``first`` (the run's
        first step) and the final step (t == 0) take the first-order update
        D = x0_t, which equals a DDIM eta = 0 step. Returns (x_next,
        x0_guided); the caller carries x0_guided as the next step's
        ``x0_prev``."""
        c = self.coeffs
        nd = x.dim()
        pred_xstart = out.pred_xstart
        abar_t = self._bcast(c.alphas_cumprod, t, nd)
        if cond_grad is not None:
            eps = self.predict_eps_from_xstart(x, t, pred_xstart)
            eps = eps - torch.sqrt(1.0 - abar_t) * cond_grad.float()
            pred_xstart = self.predict_xstart_from_eps(x, t, eps)
        x0 = pred_xstart.float()

        def lam(abar):  # half-log-SNR; the clamp engages only at abar = 1 (t = 0's target)
            return 0.5 * (torch.log(abar) - torch.log((1.0 - abar).clamp_min(1e-20)))

        abar_s = self._bcast(c.alphas_cumprod_prev, t, nd)
        abar_p = self._bcast(c.alphas_cumprod, t_prev, nd)
        lam_t, lam_s, lam_p = lam(abar_t), lam(abar_s), lam(abar_p)
        h = lam_s - lam_t
        fo = ((t == 0) | bool(first)).reshape((-1,) + (1,) * (nd - 1))
        r = torch.where(fo, torch.ones_like(h), (lam_t - lam_p) / h)
        coef = (1.0 / (2.0 * r)).clamp(max=0.5)
        d = torch.where(fo, x0, (1.0 + coef) * x0 - coef * x0_prev.float())
        sigma_t = torch.sqrt(1.0 - abar_t)
        sigma_s = torch.sqrt((1.0 - abar_s).clamp_min(0.0))
        alpha_s = torch.sqrt(abar_s)
        return (sigma_s / sigma_t) * x - alpha_s * torch.expm1(-h) * d, x0

    def ddim_sample_step(self, out: PMeanVariance, x, t, noise, cond_grad=None,
                         eta: float = 0.0):
        """DDIM step with condition_score_with_grad:
        eps' = eps - sqrt(1-abar)*grad, x0 re-predicted from eps'."""
        c = self.coeffs
        nd = x.dim()
        pred_xstart = out.pred_xstart
        abar = self._bcast(c.alphas_cumprod, t, nd)
        eps = self.predict_eps_from_xstart(x, t, pred_xstart)
        if cond_grad is not None:
            eps = eps - torch.sqrt(1.0 - abar) * cond_grad.float()
            pred_xstart = self.predict_xstart_from_eps(x, t, eps)
        abar_prev = self._bcast(c.alphas_cumprod_prev, t, nd)
        sigma = (eta * torch.sqrt((1.0 - abar_prev) / (1.0 - abar))
                 * torch.sqrt(1.0 - abar / abar_prev))
        mean_pred = (pred_xstart * torch.sqrt(abar_prev)
                     + torch.sqrt((1.0 - abar_prev - sigma ** 2).clamp_min(0.0)) * eps)
        nonzero = (t != 0).float().reshape((-1,) + (1,) * (nd - 1))
        return mean_pred + nonzero * sigma * noise


def make_diffusion(
    steps: int = 1000,
    noise_schedule: str = "linear",
    timestep_respacing: Union[str, Sequence[int], None] = None,
    rescale_timesteps: bool = False,
    learn_sigma: bool = True,
) -> GaussianDiffusion:
    """Named schedule + respacing -> GaussianDiffusion; respaced betas
    beta~_i = 1 - abar_i/abar_{i-1} over the kept subset, in float64."""
    base_betas = get_named_beta_schedule(noise_schedule, steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = str(steps)
    kept = space_timesteps(steps, timestep_respacing)
    base_alphas_cumprod = np.cumprod(1.0 - np.asarray(base_betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas = []
    for i in kept:
        new_betas.append(1.0 - base_alphas_cumprod[i] / last_alpha_cumprod)
        last_alpha_cumprod = base_alphas_cumprod[i]
    coeffs = ScheduleCoefficients.from_betas(np.array(new_betas, dtype=np.float64))
    return GaussianDiffusion(
        coeffs=coeffs,
        timestep_map=np.asarray(kept, dtype=np.int64),
        original_num_steps=steps,
        rescale_timesteps=rescale_timesteps,
        learn_sigma=learn_sigma,
    )
