"""The 3x3 conv family over the shards of a height-split activation,
counterpart of ``cgd_tpu/kernels/conv_spmd.py``.

Each function takes one data group's shards (the same batch rows, image
rows top to bottom, each on its own device) and returns the output shards.
Each is one ``torch.autograd.Function`` over all of them, so the vjp is
taken at the level of the whole tensor, as JAX's ``custom_vjp`` around the
partitioned op:

- forward: shard i gets the last row of shard i-1 as ``etop`` and the first
  row of shard i+1 as ``ebot`` (activated first, rounded to the activation
  dtype as the kernel rounds, for the prologue variants), zeros at the true
  image top and bottom, and runs K-halo (``conv3x3.conv3x3_fwd(..., etop=,
  ebot=)``: K-halo on bf16 shards, K-halo f32 on f32 ones);
- backward: the cotangent's boundary rows are exchanged the same way and
  K-halo (plain) runs with the flipped weights; the silu'/affine chain is
  plain PyTorch in f32, as ``_fused_bwd_common`` with ``conv_fn=_p_plain``,
  and dA / dB are summed over the shards (A / B carry global GroupNorm
  statistics); the weight gradient is cuDNN's on the stacked rows.

``place(t, device)`` puts a weight on a shard's device (``Mesh.place``: the
replica where there is one).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from cgd_tpu_torch.kernels import conv3x3 as k3

Place = Callable[[torch.Tensor, torch.device], torch.Tensor]


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev)


def _act_rows(rows, A, B):
    """The kernel's prologue on boundary rows: silu(rows*A + B) in f32, cast
    back to the activation dtype (the JAX package's ``_act_rows``)."""
    return k3._silu_chain(rows, A, B)[2].to(rows.dtype)


def halo_rows(tops: Sequence[torch.Tensor], bots: Sequence[torch.Tensor]):
    """(etop, ebot) per shard from each shard's first and last row: shard i
    takes ``bots[i-1]`` and ``tops[i+1]`` on its own device, zeros at the true
    image edges (what ppermute zero-fills)."""
    n = len(tops)
    devs = [t.device for t in tops]
    etop = [torch.zeros_like(bots[0], device=devs[0])]
    etop += [bots[i - 1].to(devs[i]) for i in range(1, n)]
    ebot = [tops[i + 1].to(devs[i]) for i in range(n - 1)]
    ebot += [torch.zeros_like(tops[-1], device=devs[-1])]
    return etop, ebot


def _conv_shards(xs, w, bias, place: Place, A=None, B=None, skips=None):
    """K-halo over the shards."""
    devs = [x.device for x in xs]
    As = [None if A is None else place(A, d) for d in devs]
    Bs = [None if B is None else place(B, d) for d in devs]
    tops = [x[:, :1] if a is None else _act_rows(x[:, :1], a, b) for x, a, b in zip(xs, As, Bs)]
    bots = [x[:, -1:] if a is None else _act_rows(x[:, -1:], a, b) for x, a, b in zip(xs, As, Bs)]
    etop, ebot = halo_rows(tops, bots)
    skips = skips if skips is not None else [None] * len(xs)
    return [k3.conv3x3_fwd(x.contiguous(), place(w, d), place(bias, d), a, b, s,
                           etop=et.contiguous(), ebot=eb.contiguous())
            for x, d, a, b, s, et, eb in zip(xs, devs, As, Bs, skips, etop, ebot)]


class _HaloConv(torch.autograd.Function):
    """conv3x3([silu(x*A + B)]) + bias [+ skip] over all shards of a group."""

    @staticmethod
    def forward(ctx, place, n, w, bias, A, B, *xs_skips):
        xs, skips = xs_skips[:n], (xs_skips[n:] or None)
        outs = _conv_shards(xs, w, bias, place, A, B, skips)
        ctx.place, ctx.n, ctx.has_skip = place, n, skips is not None
        ctx.save_for_backward(w, A, B, *xs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        w, A, B, *xs = ctx.saved_tensors
        place = ctx.place
        gs = [g.contiguous() for g in gs]
        devs = [x.device for x in xs]
        dxs, dA, dB, dw, db = [None] * ctx.n, None, None, None, None
        needs = ctx.needs_input_grad
        if any(needs[4:6]) or any(needs[6:6 + ctx.n]):
            wt = k3._flip_t(w)
            zero = torch.zeros(w.shape[2], dtype=w.dtype, device=w.device)
            das = _conv_shards(gs, wt, zero, place)
            if A is None:
                dxs = das
            else:
                dxs = []
                for x, da, d in zip(xs, das, devs):
                    a = place(A, d)
                    pre, sig, _ = k3._silu_chain(x, a, place(B, d))
                    dpre = da.float() * (sig * (1.0 + pre * (1.0 - sig)))
                    dxs.append((dpre * a[:, None, None, :]).to(x.dtype))
                    pa = (dpre * x.float()).sum((1, 2)).to(A.device)
                    pb = dpre.sum((1, 2)).to(A.device)
                    dA = pa if dA is None else dA + pa
                    dB = pb if dB is None else dB + pb
        if needs[2]:
            acts = [x if A is None else _act_rows(x, place(A, d), place(B, d))
                    for x, d in zip(xs, devs)]
            etop, ebot = halo_rows([a[:, :1] for a in acts], [a[:, -1:] for a in acts])
            dw = sum(k3._dw(torch.cat([et, a, eb], dim=1), place(w, d), g, padding=(0, 1))
                     .to(w.device) for a, et, eb, g, d in zip(acts, etop, ebot, gs, devs))
        if needs[3]:
            db = sum(k3._db(g).to(w.device) for g in gs)
        dskips = list(gs) if ctx.has_skip else []
        return (None, None, dw, db, dA, dB, *dxs, *dskips)


def conv3x3_shards_plain(xs, w, bias, A=None, B=None, skips=None) -> List[torch.Tensor]:
    """Plain PyTorch version of the three functions below, differentiable by
    autograd: the same halo rows, ``conv3x3_fwd_halo_plain`` per shard."""
    acts = xs if A is None else [_act_rows(x, A.to(x.device), B.to(x.device)) for x in xs]
    etop, ebot = halo_rows([a[:, :1] for a in acts], [a[:, -1:] for a in acts])
    skips = skips if skips is not None else [None] * len(xs)
    return [k3.conv3x3_fwd_halo_plain(x, w.to(x.device), bias.to(x.device),
                                      None if A is None else A.to(x.device),
                                      None if B is None else B.to(x.device), s, et, eb)
            for x, s, et, eb in zip(xs, skips, etop, ebot)]


def conv3x3(xs: Sequence[torch.Tensor], w, bias, place: Place = _to) -> List[torch.Tensor]:
    """3x3 stride-1 pad-1 conv of a height-split image, bias fused (K-halo;
    dx on K-halo)."""
    return list(_HaloConv.apply(place, len(xs), w, bias, None, None, *xs))


def conv3x3_gn_silu(xs, A, B, w, bias, place: Place = _to) -> List[torch.Tensor]:
    """conv3x3(silu(x*A + B)) + bias over the shards; A/B [b, cin] f32 on
    the group's first device."""
    return list(_HaloConv.apply(place, len(xs), w, bias, A, B, *xs))


def conv3x3_gn_silu_add(xs, A, B, w, bias, skips: Optional[Sequence[torch.Tensor]],
                        place: Place = _to) -> List[torch.Tensor]:
    """conv3x3(silu(x*A + B)) + bias + skip over the shards."""
    return list(_HaloConv.apply(place, len(xs), w, bias, A, B, *xs, *skips))
