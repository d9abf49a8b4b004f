"""The augmentation warp's bilinear sampling (``guidance/cutouts.apply_augs``)
with a deterministic backward: K-warp-b (``csrc/warp_bwd.cu``), its plain
PyTorch version, and the autograd Function the warp calls.

The JAX package samples the warp with ``map_coordinates(order=1,
mode="nearest")`` (``cgd_tpu/guidance/cutouts.py:151``), whose transpose is a
scatter that XLA runs deterministically; it has no Pallas kernel. The port's
forward gathers the four clamped taps of each output pixel and sums them
weighted, in ``map_coordinates``' order. Autograd's backward of that gather
on a card is ``scatter_add_`` with float atomics, whose order of additions
changes from run to run, so the guided gradient under ``use_augs`` would not
be reproducible and a resumed run would not equal the uninterrupted one.

Here the backward is a segment sum in a fixed order. ``warp_index`` keys
each (tap, output pixel) pair by ``cutout * h * w + source pixel`` and sorts
the keys stably (so inside a segment the pairs keep their (tap, output
pixel) order, whatever the values); K-warp-b walks each source pixel's
segment in that order, one thread per (source pixel, channel), with no
atomics: it sums ``w * g`` per tap, then the four taps' sums as
``((S3 + S2) + S1) + S0``. That is the order in which autograd's backward
of the gather adds on the CPU (each tap's scatter over the output pixels in
order, then the taps' gradients accumulated from the last tap to the
first), so the gradient is bit-equal to the gather's on the CPU. The
index depends on the draw only, not on the image, and is built once per
backward.

Dispatch: a tensor on the CPU takes the plain version (``index_add_`` over
the sorted pairs of each tap, one addition after another, then the same sum
of the taps: bit-equal to the kernel on the same inputs); a CUDA tensor
launches the kernel or raises. Launches are counted in ``LAUNCHES``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cgd_tpu_torch.kernels import _build

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {"warp_bwd": 0}

TAPS = 4  # the bilinear corners, in map_coordinates' order
_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class WarpIndex(NamedTuple):
    """The (tap, output pixel) pairs of one warp, sorted by source pixel."""

    key: torch.Tensor  # [P] int64: cutout * h * w + source pixel, ascending
    pair: torch.Tensor  # [P] int32: tap * n * h * w + the output pixel (cutout * h * w + p)
    weight: torch.Tensor  # [P] f32: the pair's bilinear weight
    offsets: torch.Tensor  # [n * h * w + 1] int32: each source pixel's first pair


def warp_index(idx: torch.Tensor, weight: torch.Tensor) -> WarpIndex:
    """idx [TAPS, n, h, w] (the source pixel of each tap, in [0, h * w))
    and weight [TAPS, n, h, w] -> the pairs sorted by (cutout, source
    pixel), in (tap, cutout, output pixel) order inside each segment."""
    taps, n, hh, ww = idx.shape
    hw, nsrc = hh * ww, n * hh * ww
    if taps != TAPS:
        raise ValueError(f"warp_index: {taps} taps, the warp has {TAPS}")
    if taps * nsrc > _INT32_MAX:
        raise ValueError(f"warp_index: {taps * nsrc} pairs do not fit int32 indices")
    dev = idx.device
    keys = (torch.arange(n, device=dev)[:, None] * hw + idx.reshape(taps, n, hw)).reshape(-1)
    key, perm = torch.sort(keys, stable=True)
    offsets = torch.searchsorted(key, torch.arange(nsrc + 1, device=dev))
    return WarpIndex(key, perm.int(), weight.reshape(-1)[perm].float(), offsets.int())


def warp_bwd_plain(g: torch.Tensor, index: WarpIndex) -> torch.Tensor:
    """dx[s, ch] = S3 + S2 + S1 + S0, summed in that order, where S_t is the
    sum of weight * g[output pixel, ch] over source pixel s's pairs of tap
    t, in their sorted order. g [n * h * w, c] f32 -> the same."""
    nsrc, c = g.shape
    pair = index.pair.long()
    prod = index.weight[:, None] * g[pair % nsrc]
    # one sum per (tap, source pixel, channel), each one addition after another
    flat = (((pair // nsrc) * nsrc + index.key)[:, None] * c
            + torch.arange(c, device=g.device)).reshape(-1)
    s = torch.zeros(TAPS * nsrc * c, dtype=torch.float32, device=g.device).index_add_(
        0, flat, prod.reshape(-1)).reshape(TAPS, nsrc, c)
    return ((s[3] + s[2]) + s[1]) + s[0]


def warp_bwd(g: torch.Tensor, index: WarpIndex) -> torch.Tensor:
    """K-warp-b on a card, the plain version on the CPU. g [n * h * w, c]
    f32 (the warp's output cotangent) -> the input's gradient, the same
    shape."""
    if g.device.type == "cpu":
        return warp_bwd_plain(g, index)
    return _warp_bwd_kernel(g, index)


def _warp_bwd_kernel(g: torch.Tensor, index: WarpIndex) -> torch.Tensor:
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"warp_bwd: no kernel for device {dev}")
    nsrc, c = g.shape
    for name, t, dtype, numel in (("g", g, torch.float32, nsrc * c),
                                  ("weight", index.weight, torch.float32, TAPS * nsrc),
                                  ("pair", index.pair, torch.int32, TAPS * nsrc),
                                  ("offsets", index.offsets, torch.int32, nsrc + 1)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"warp_bwd: {name} must be a contiguous {dtype} tensor of "
                             f"{numel} elements on {dev}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if nsrc * c > _INT32_MAX:
        raise ValueError(f"warp_bwd: {nsrc} x {c} elements do not fit int32 indices")
    dx = torch.empty_like(g)
    with torch.cuda.device(dev):
        status = _build.library().cgd_warp_bwd(
            g.data_ptr(), index.weight.data_ptr(), index.pair.data_ptr(),
            index.offsets.data_ptr(), dx.data_ptr(), nsrc, c, _build.stream(dev))
    _build.check(status, "warp_bwd")
    LAUNCHES["warp_bwd"] += 1
    return dx


def gather_warp(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The warp's forward: the four taps gathered and summed weighted, in
    map_coordinates' order. Called under autograd it is also the route
    ``bilinear_warp`` replaced, whose backward on a card is ``scatter_add_``
    with float atomics (the checks compare the two)."""
    n, hh, ww, c = x.shape
    flat = x.reshape(n, hh * ww, c)
    out = None
    for t in range(idx.shape[0]):  # the taps summed in their order
        tap = flat.gather(1, idx[t].reshape(n, hh * ww, 1).expand(n, hh * ww, c))
        term = weight[t][..., None] * tap.reshape(n, hh, ww, c)
        out = term if out is None else out + term
    return out


class _BilinearWarp(torch.autograd.Function):
    """out = sum over taps t of weight[t] * x at idx[t]; its backward is
    ``warp_bwd`` (the gradient reaches x only: idx and weight come from the
    draw)."""

    @staticmethod
    def forward(ctx, x, idx, weight):
        ctx.save_for_backward(idx, weight)
        return gather_warp(x, idx, weight)

    @staticmethod
    def backward(ctx, g):
        idx, weight = ctx.saved_tensors
        n, hh, ww, c = g.shape
        dx = warp_bwd(g.float().contiguous().reshape(n * hh * ww, c), warp_index(idx, weight))
        return dx.reshape(n, hh, ww, c), None, None


def bilinear_warp(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [n, h, w, c] f32, idx [TAPS, n, h, w] int64 source pixels (row * w
    + column, already clamped), weight [TAPS, n, h, w] f32 -> [n, h, w, c]:
    each output pixel the weighted sum of its taps, differentiable in x."""
    return _BilinearWarp.apply(x, idx, weight)
