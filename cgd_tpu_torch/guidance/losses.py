"""Guidance losses over NHWC tensors, counterpart of
``cgd_tpu/guidance/losses.py`` (range, spherical distance, total variation,
saturation)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def range_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean squared overshoot outside [-1, 1]; per-batch over HWC."""
    over = x - x.clamp(-1.0, 1.0)
    return over.square().mean(dim=tuple(range(1, x.dim())))


def spherical_dist_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 * arcsin(||x^ - y^|| / 2)^2 between L2-normalized embeddings,
    broadcasting over leading dims."""
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    chord = torch.linalg.vector_norm(xn - yn, dim=-1)
    return torch.arcsin(chord / 2.0).square() * 2.0


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """L2 total variation with replicate padding on the bottom/right edge,
    per-batch. x: [B,H,W,C]."""
    xp = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1), mode="replicate").permute(0, 2, 3, 1)
    x_diff = xp[:, :-1, 1:, :] - xp[:, :-1, :-1, :]
    y_diff = xp[:, 1:, :-1, :] - xp[:, :-1, :-1, :]
    return (x_diff.square() + y_diff.square()).mean(dim=(1, 2, 3))


def saturation_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean absolute overshoot outside [-1, 1] (scalar)."""
    return (x - x.clamp(-1.0, 1.0)).abs().mean()
