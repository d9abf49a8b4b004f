"""Noise schedules and derived coefficient arrays — a copy of
``cgd_tpu/diffusion/schedules.py`` (pure numpy, f64 math), kept import-free of
jax; pinned to the original by tests/test_torch_port_step.py.

Reimplements the mathematical contract of guided_diffusion's
``get_named_beta_schedule`` / ``GaussianDiffusion`` coefficient precomputation
(external dep of the reference; contract documented in SURVEY.md §2b and
exercised by the reference at cgd/script_util.py:313 and cgd/cgd.py:177).

All arrays are computed in float64 on host (NumPy) for bit-stable parity with
the reference's float64 NumPy precompute, then exposed as a frozen dataclass of
float32 arrays (≤1000 elements each; the sampler moves them to the device once).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Create betas that discretize the given alpha_t_bar function.

    beta[i] = 1 - alpha_bar((i+1)/T) / alpha_bar(i/T), capped at ``max_beta``.
    """
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedule: "linear" or "cosine".

    linear: beta goes linearly from 0.0001 to 0.02, scaled by 1000/T so that
    any T has an equivalent limiting continuous-time process.
    cosine: alpha_bar(t) = cos^2((t + 0.008)/1.008 * pi/2), betas capped 0.999.
    (Contract per SURVEY.md §2b, gaussian_diffusion row.)
    """
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        beta_start = scale * 0.0001
        beta_end = scale * 0.02
        return np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
    elif schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


@dataclasses.dataclass(frozen=True)
class ScheduleCoefficients:
    """All per-timestep coefficient arrays the samplers need, precomputed.

    Every field is a float32 numpy array of shape [T].
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    log_betas: np.ndarray  # for learned-sigma interpolation (fp64-derived)

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @staticmethod
    def from_betas(betas: np.ndarray) -> "ScheduleCoefficients":
        betas = np.asarray(betas, dtype=np.float64)
        assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        # Log-variance clipped because posterior_variance[0] == 0.
        if len(posterior_variance) > 1:
            posterior_log_variance_clipped = np.log(
                np.append(posterior_variance[1], posterior_variance[1:])
            )
        else:
            posterior_log_variance_clipped = np.log(np.array([posterior_variance[0]]))

        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return ScheduleCoefficients(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            alphas_cumprod_next=f32(alphas_cumprod_next),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            log_betas=f32(np.log(betas)),
        )
