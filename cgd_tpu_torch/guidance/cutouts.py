"""Random cutouts as separable box-filter matmuls, counterpart of
``cgd_tpu/guidance/cutouts.py``: for cutout k, two small weight matrices
W_y [cut, H] and W_x [cut, W] hold the overlap of each output bin with each
input pixel, and the cutout is einsum(W_y, image, W_x) — differentiable in
the image, equal in expectation to crop + adaptive average pool.

The augmentations (``use_augs``, the reference's ``cgd/modules.py:12-22``)
are split in two: ``draw_augs`` makes every random choice from the step's
generator, and ``apply_augs`` is a function of the cutouts and those draws
(what the tests hold against ``cgd_tpu.guidance.cutouts.augment_cutouts``
with the JAX draws injected).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cgd_tpu_torch.kernels import warp


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


class AugDraws(NamedTuple):
    """The random choices of one augmentation pass over n cutouts."""

    flip: torch.Tensor  # [n] bool: mirror left-right (p 0.5)
    angle: torch.Tensor  # [n] rotation in degrees, uniform in [-15, 15)
    tx: torch.Tensor  # [n] translation, a fraction of the width in [-0.1, 0.1)
    ty: torch.Tensor  # [n] the same, of the height
    persp_on: torch.Tensor  # [n] bool: the perspective term applies (p 0.7)
    persp: torch.Tensor  # [n, 2] its x and y terms, uniform in +-0.4 / max(h, w)
    gray: torch.Tensor  # [n] bool: to luma (p 0.15)
    noise: torch.Tensor  # [n, h, w, c] standard normal, scaled by 0.02 when applied


def draw_augs(gen: torch.Generator, n: int, h: int, w: int, c: int) -> AugDraws:
    """The draws of ``apply_augs`` for n cutouts of h x w x c, from ``gen``
    (on its device), in the order of ``AugDraws``'s fields, as the JAX
    package splits its key into eight."""
    dev = gen.device

    def uniform(*shape, lo, hi):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    lim = 0.4 / max(h, w)
    return AugDraws(
        flip=torch.rand(n, generator=gen, device=dev) < 0.5,
        angle=uniform(n, lo=-15.0, hi=15.0),
        tx=uniform(n, lo=-0.1, hi=0.1),
        ty=uniform(n, lo=-0.1, hi=0.1),
        persp_on=torch.rand(n, generator=gen, device=dev) < 0.7,
        persp=uniform(n, 2, lo=-lim, hi=lim),
        gray=torch.rand(n, generator=gen, device=dev) < 0.15,
        noise=torch.randn(n, h, w, c, generator=gen, device=dev),
    )


def apply_augs(cutouts: torch.Tensor, d: AugDraws) -> torch.Tensor:
    """``augment_cutouts`` of the JAX package with its draws given: a
    left-right flip, then one projective warp (rotation, translation and a
    perspective term about the centre) sampled bilinearly with each index
    clamped to the image (``map_coordinates(order=1, mode="nearest")``; the
    +-10% translation reaches the edges on every draw; ``kernels.warp``,
    whose backward sums in a fixed order), then grayscale
    (ITU-R 601 luma), then Gaussian noise of std 0.02 (the reference's four
    passes of 0.01). [n, h, w, c] -> the same, differentiable in the
    cutouts."""
    n, hh, ww, c = cutouts.shape
    x = cutouts.float()
    x = torch.where(d.flip[:, None, None, None], x.flip(2), x)

    theta = d.angle * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    tx, ty = (d.tx * ww)[:, None, None], (d.ty * hh)[:, None, None]
    persp = torch.where(d.persp_on[:, None], d.persp, torch.zeros_like(d.persp))
    cy, cx = (hh - 1) / 2.0, (ww - 1) / 2.0
    yc = (torch.arange(hh, dtype=torch.float32, device=x.device) - cy)[None, :, None]
    xc = (torch.arange(ww, dtype=torch.float32, device=x.device) - cx)[None, None, :]
    denom = 1.0 + persp[:, 0, None, None] * xc + persp[:, 1, None, None] * yc
    xs = (cos * xc + sin * yc) / denom + cx - tx  # [n, h, w] source coordinates
    ys = (-sin * xc + cos * yc) / denom + cy - ty

    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy = [(y0 + o).clamp(0, hh - 1).long() for o in (0, 1)]
    ix = [(x0 + o).clamp(0, ww - 1).long() for o in (0, 1)]
    # the four corners summed in map_coordinates' order; the backward is a
    # fixed-order segment sum (K-warp-b on a card), not atomics
    corners = ((0, 0), (0, 1), (1, 0), (1, 1))
    idx = torch.stack([iy[a] * ww + ix[b] for a, b in corners])
    weight = torch.stack([(wy0, wy1)[a] * (wx0, wx1)[b] for a, b in corners])
    x = warp.bilinear_warp(x, idx, weight)

    luma = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]
    x = torch.where(d.gray[:, None, None, None], luma.expand_as(x), x)
    return (x + 0.02 * d.noise).to(cutouts.dtype)
