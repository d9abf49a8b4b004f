"""Random cutouts as separable box-filter matmuls, counterpart of
``cgd_tpu/guidance/cutouts.py``: for cutout k, two small weight matrices
W_y [cut, H] and W_x [cut, W] hold the overlap of each output bin with each
input pixel, and the cutout is einsum(W_y, image, W_x) — differentiable in
the image, equal in expectation to crop + adaptive average pool.
(``augment_cutouts`` is not ported yet.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CutoutSpec(NamedTuple):
    """Per-cutout crop coordinates (float32 tensors of shape [K])."""

    offset_x: torch.Tensor
    offset_y: torch.Tensor
    size: torch.Tensor


def sample_cutout_coords(
    gen: torch.Generator,
    num_cutouts: int,
    side_x: int,
    side_y: int,
    cut_size: int,
    cut_pow: float = 1.0,
    device=None,
) -> CutoutSpec:
    """size = floor(u^pow * (max-min) + min), max = min(side_x, side_y),
    min = min(side_x, side_y, cut_size); offsets uniform integers in
    [0, side - size]. Drawn from ``gen`` (on ``gen``'s device)."""
    device = device if device is not None else gen.device
    max_size = min(side_y, side_x)
    min_size = min(side_y, side_x, cut_size)
    u = torch.rand(num_cutouts, generator=gen, device=device)
    size = torch.floor(u ** cut_pow * (max_size - min_size) + min_size)
    ux = torch.rand(num_cutouts, generator=gen, device=device)
    uy = torch.rand(num_cutouts, generator=gen, device=device)
    offset_x = torch.floor(ux * (side_x - size + 1.0))
    offset_y = torch.floor(uy * (side_y - size + 1.0))
    return CutoutSpec(offset_x, offset_y, size)


def _box_weights(offset: torch.Tensor, size: torch.Tensor, in_size: int, out_size: int):
    """[K] offsets/sizes -> [K, out_size, in_size] box-filter matrices."""
    i = torch.arange(out_size, dtype=torch.float32, device=offset.device)
    j = torch.arange(in_size, dtype=torch.float32, device=offset.device)
    scale = size[:, None] / out_size  # bin i covers [lo, lo + scale)
    lo = offset[:, None] + i[None, :] * scale
    hi = lo + scale
    overlap = (torch.minimum(hi[:, :, None], j[None, None, :] + 1.0)
               - torch.maximum(lo[:, :, None], j[None, None, :])).clamp_min(0.0)
    return overlap / scale[:, :, None]  # rows sum to 1


def make_cutouts(image: torch.Tensor, spec: CutoutSpec, cut_size: int) -> torch.Tensor:
    """image [B,H,W,C] -> [K*B, cut, cut, C], cutout-major (index k*B + b)."""
    b, h, w, c = image.shape
    wy = _box_weights(spec.offset_y, spec.size, h, cut_size)  # [K,cut,H]
    wx = _box_weights(spec.offset_x, spec.size, w, cut_size)  # [K,cut,W]
    img = image.float()
    tmp = torch.einsum("kyh,bhwc->kbywc", wy, img)
    out = torch.einsum("kxw,kbywc->kbyxc", wx, tmp)
    return out.reshape(spec.size.shape[0] * b, cut_size, cut_size, c).to(image.dtype)
