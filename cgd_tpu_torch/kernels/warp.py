"""The augmentation warp's bilinear sampling (``guidance/cutouts.apply_augs``)
with a deterministic backward: K-warp-b (``csrc/warp_bwd.cu``) and the index
it reads, K-warp-i (``csrc/warp_index.cu``), their plain PyTorch versions,
and the autograd Function the warp calls.

The JAX package samples the warp with ``map_coordinates(order=1,
mode="nearest")`` (``cgd_tpu/guidance/cutouts.py:151``), whose transpose is a
scatter that XLA runs deterministically; it has no Pallas kernel. The port's
forward gathers the four clamped taps of each output pixel and sums them
weighted, in ``map_coordinates``' order. Autograd's backward of that gather
on a card is ``scatter_add_`` with float atomics, whose order of additions
changes from run to run, so the guided gradient under ``use_augs`` would not
be reproducible and a resumed run would not equal the uninterrupted one.

Here the backward is a segment sum in a fixed order. ``warp_index`` sorts
each (tap, output pixel) pair stably by its bin ``(cutout * h * w + source
pixel) * TAPS + tap``, so a source pixel's segment holds its taps' bins one
after another, each in output pixel order, whatever the values; each bin's
first pair comes from a histogram of the bins and an exclusive scan
(integer counts, whatever the order), and the segments longer than
``LONG_PAIRS`` pairs are listed in ascending order (a stable partition of
the source pixels). K-warp-b sums each bin in that order (one thread per
short segment, all channels; a warp per tap of a long one, its loads 128
pairs at a time), ``w * g`` rounded, then the four taps' sums as ``((S3 +
S2) + S1) + S0``. That is the order in which autograd's backward of the
gather adds on the CPU (each tap's scatter over the output pixels in order,
then the taps' gradients accumulated from the last tap to the first), so
the gradient is bit-equal to the gather's on the CPU. The index depends on
the draw only, not on the image, and is built once per backward.

Dispatch: tensors on the CPU take the plain versions (a stable library sort
of the bins for the index; ``index_add_`` over the sorted pairs of each
bin, one addition after another, then the same sum of the taps, for the
backward: each bit-equal to its kernel on the same inputs); CUDA tensors
launch the kernels or raise. Launches are counted in ``LAUNCHES``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cgd_tpu_torch.kernels import _build

# launches of each kernel since the last reset_launch_counts()
# (a replayed CUDA graph adds what its capture counted: launch_counters)
LAUNCHES = {"warp_bwd": 0, "warp_index": 0}

TAPS = 4  # the bilinear corners, in map_coordinates' order
# a segment longer than this is summed by a block (a warp per tap), a
# shorter one by one thread
LONG_PAIRS = 32
_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class WarpIndex(NamedTuple):
    """The (tap, output pixel) pairs of one warp, sorted stably by their bin
    (cutout * h * w + source pixel) * TAPS + tap, where each bin starts,
    and which segments (a source pixel's four bins) are long."""

    pair: torch.Tensor  # [P] int32: the output pixel, cutout * h * w + p
    weight: torch.Tensor  # [P] f32: the pair's bilinear weight
    offsets: torch.Tensor  # [TAPS * n * h * w + 1] int32: each bin's first pair
    long: torch.Tensor  # [n * h * w] int32: the long segments' pixels ascending, then the rest
    n_long: torch.Tensor  # [1] int32: how many segments hold more than LONG_PAIRS pairs


def warp_index(idx: torch.Tensor, weight: torch.Tensor) -> WarpIndex:
    """idx [TAPS, n, h, w] (the source pixel of each tap, in [0, h * w))
    and weight [TAPS, n, h, w] -> the pairs sorted by (cutout, source
    pixel, tap), in output pixel order inside each bin. K-warp-i on a card
    (the same index as the plain version, bit for bit), the plain version
    on the CPU; no step waits for the device."""
    taps, n, hh, ww = idx.shape
    if taps != TAPS:
        raise ValueError(f"warp_index: {taps} taps, the warp has {TAPS}")
    if taps * n * hh * ww > _INT32_MAX:
        raise ValueError(f"warp_index: {taps * n * hh * ww} pairs do not fit int32 indices")
    if idx.device.type == "cpu":
        return warp_index_plain(idx, weight)
    return _warp_index_kernel(idx, weight)


def warp_index_plain(idx: torch.Tensor, weight: torch.Tensor) -> WarpIndex:
    """The index by a stable library sort of the bins, and their starts
    from a histogram and an exclusive scan."""
    taps, n, hh, ww = idx.shape
    hw, nsrc, i32 = hh * ww, n * hh * ww, torch.int32
    dev = idx.device
    src = torch.arange(n, device=dev, dtype=i32)[:, None] * hw + idx.reshape(taps, n, hw).to(i32)
    bins = (src * TAPS + torch.arange(taps, device=dev, dtype=i32)[:, None, None]).reshape(-1)
    perm = torch.sort(bins, stable=True)[1]
    counts = torch.zeros(taps * nsrc, device=dev, dtype=i32).index_add_(0, bins,
                                                                        torch.ones_like(bins))
    offsets = F.pad(counts.cumsum(0, dtype=i32), (1, 0))
    return WarpIndex((perm % nsrc).to(i32), weight.reshape(-1)[perm].float(), offsets,
                     *_long_segments(offsets))


def _long_segments(offsets: torch.Tensor) -> tuple:
    """The source pixels whose segment holds more than LONG_PAIRS pairs,
    ascending, then the others: a stable partition with every destination
    distinct (no sort, no host sync); and how many are long."""
    is_long = offsets[TAPS::TAPS] - offsets[:-1:TAPS] > LONG_PAIRS
    longs_to = is_long.cumsum(0, dtype=torch.int32)
    n_long = longs_to[-1:]
    pixels = torch.arange(is_long.numel(), device=offsets.device, dtype=torch.int32)
    dest = torch.where(is_long, longs_to - 1, n_long + pixels - longs_to)
    return torch.empty_like(pixels).scatter_(0, dest.long(), pixels), n_long


def _warp_index_kernel(idx: torch.Tensor, weight: torch.Tensor) -> WarpIndex:
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"warp_index: no kernel for device {dev}")
    taps, n, hh, ww = idx.shape
    hw, nsrc, i32 = hh * ww, n * hh * ww, torch.int32
    if idx.dtype != torch.int64 or weight.shape != idx.shape or weight.device != dev:
        raise ValueError(f"warp_index: idx must be int64 and weight of its shape on {dev}; got "
                         f"{idx.dtype} {tuple(idx.shape)}, {tuple(weight.shape)} on "
                         f"{weight.device}")
    idx, weight = idx.contiguous(), weight.float().contiguous()
    pairs = taps * nsrc
    bins, slot, held, pair = (torch.empty(pairs, device=dev, dtype=i32) for _ in range(4))
    counts = torch.zeros(pairs, device=dev, dtype=i32)
    offsets = torch.empty(pairs + 1, device=dev, dtype=i32)
    weight_out = torch.empty_like(weight)
    long, n_long = torch.empty(nsrc, device=dev, dtype=i32), torch.empty(1, device=dev, dtype=i32)
    lib, stream = _build.library(), _build.stream(dev)
    block_counts = torch.empty(lib.cgd_warp_index_long_blocks(nsrc), device=dev, dtype=i32)
    with torch.cuda.device(dev):
        status = lib.cgd_warp_index_count(idx.data_ptr(), bins.data_ptr(), slot.data_ptr(),
                                          counts.data_ptr(), nsrc, hw, stream)
        _build.check(status, "warp_index")
        offsets[:1].zero_()
        torch.cumsum(counts, 0, dtype=i32, out=offsets[1:])  # the exclusive scan
        status = lib.cgd_warp_index_sort(bins.data_ptr(), slot.data_ptr(), offsets.data_ptr(),
                                         held.data_ptr(), weight.data_ptr(), pair.data_ptr(),
                                         weight_out.data_ptr(), nsrc, stream)
        _build.check(status, "warp_index")
        status = lib.cgd_warp_index_long(offsets.data_ptr(), block_counts.data_ptr(),
                                         long.data_ptr(), n_long.data_ptr(), nsrc, LONG_PAIRS,
                                         stream)
    _build.check(status, "warp_index")
    LAUNCHES["warp_index"] += 1
    return WarpIndex(pair, weight_out.reshape(-1), offsets, long, n_long)


def warp_bwd_plain(g: torch.Tensor, index: WarpIndex) -> torch.Tensor:
    """dx[s, ch] = S3 + S2 + S1 + S0, summed in that order, where S_t is the
    sum of weight * g[output pixel, ch] over the pairs of bin (s, t), in
    their sorted order. g [n * h * w, c] f32 -> the same."""
    nsrc, c = g.shape
    pairs = index.pair.numel()
    # each pair's bin, from the bins' starts (no host sync)
    bins = torch.repeat_interleave(torch.arange(TAPS * nsrc, device=g.device),
                                   index.offsets.diff(), output_size=pairs)
    prod = index.weight[:, None] * g[index.pair.long()]
    # one sum per (tap, source pixel, channel), each one addition after another
    flat = (((bins % TAPS) * nsrc + bins // TAPS)[:, None] * c
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
                                  ("offsets", index.offsets, torch.int32, TAPS * nsrc + 1),
                                  ("long", index.long, torch.int32, nsrc),
                                  ("n_long", index.n_long, torch.int32, 1)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"warp_bwd: {name} must be a contiguous {dtype} tensor of "
                             f"{numel} elements on {dev}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if nsrc * c > _INT32_MAX:
        raise ValueError(f"warp_bwd: {nsrc} x {c} elements do not fit int32 indices")
    if index.offsets.data_ptr() % 16:  # the kernel reads a pixel's four bin starts at once
        raise ValueError("warp_bwd: offsets must start on a 16-byte boundary")
    dx = torch.empty_like(g)
    with torch.cuda.device(dev):
        status = _build.library().cgd_warp_bwd(
            g.data_ptr(), index.weight.data_ptr(), index.pair.data_ptr(),
            index.offsets.data_ptr(), index.long.data_ptr(), index.n_long.data_ptr(),
            dx.data_ptr(), nsrc, c, LONG_PAIRS, _build.stream(dev))
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
