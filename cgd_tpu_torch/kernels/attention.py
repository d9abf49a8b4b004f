"""Multi-head self-attention on Hopper: K-attn-f and K-attn-b, their plain
PyTorch versions, the launch plan, and the autograd Function the UNet calls.

Counterpart of ``cgd_tpu/kernels/attention_pallas.py``. Hand-written CUDA
kernels replace its two Pallas kernels: a flash-attention forward that also
writes the per-row log-sum-exp, and a deterministic backward that recomputes
P from it. Head dims 64 and 128 (every UNet attention at 64-512px is d = 64)
run the Hopper bodies of ``csrc/attn_fwd.cu`` and ``csrc/attn_bwd.cu`` (TMA
ring, a producer warpgroup, two consumer warpgroups on ``wgmma`` with the
softmax and the accumulators in registers; a two-launch backward); 192 and
256 (the 128px model only) keep PR 2's WMMA bodies, ``csrc/attn_wmma.cu``.
``attn_plan`` is the launch geometry the wrapper and the kernels agree on.

- ``attention_fwd_plain`` / ``attention_bwd_plain``: exactly the math of
  ``_fwd_kernel`` / ``_bwd_kernel`` on ``[N, T, d]`` (q and k each scaled by
  d^-1/4, everything in f32, P kept in f32), results in q's dtype;
- ``attention_fwd`` / ``attention_bwd``: the kernels, reading q, k, v in
  place from the UNet's fused ``[B, T, 3C]`` qkv (``[q_heads | k_heads |
  v_heads]``) and writing ``[B, T, C]`` / ``[B, T, 3C]``;
- ``qkv_attention``: the ``torch.autograd.Function`` mirroring
  ``flash_mha``'s ``custom_vjp``.

Dispatch: a tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels or raises (a head dim outside 64/128/192/256, a dtype
other than bfloat16, a failed build). Nothing falls back.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from cgd_tpu_torch.kernels import _build

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {"attn_fwd": 0, "attn_bwd": 0}

HEAD_DIMS = (64, 128, 192, 256)  # the kernels' templates
WGMMA_HEAD_DIMS = (64, 128)      # the Hopper bodies; the others run the WMMA bodies

# the Hopper bodies' geometry (csrc/attn_common.cuh)
ROWS = 64         # rows of every tile (the wgmma M) and of the TMA box
STAGES = 4        # streamed tiles in the ring: two for each consumer warpgroup
SMEM_MAX = 232448  # shared memory one block may take on the H100
_ALIGN = 1024


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _probs(q, k):
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(d))
    s = (q.float() * scale) @ (k.float() * scale).transpose(-1, -2)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    return p / p.sum(-1, keepdim=True), scale * scale


def attention_fwd_plain(q, k, v):
    """softmax(q k^T / sqrt(d)) v for q, k, v [N, T, d]; f32 math, q's dtype out."""
    p, _ = _probs(q, k)
    return (p @ v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, g) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention_fwd_plain for cotangent g, P recomputed."""
    p, s2 = _probs(q, k)
    g = g.float()
    dp = g @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k.float()) * s2
    dk = (ds.transpose(-1, -2) @ q.float()) * s2
    dv = p.transpose(-1, -2) @ g
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def to_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*d] -> [B*H, T, d]."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2).reshape(b * num_heads, t, -1)


def split_heads(qkv: torch.Tensor, num_heads: int):
    """[B, T, 3C] -> q, k, v as [B*H, T, d]."""
    return tuple(to_heads(z, num_heads) for z in qkv.chunk(3, dim=-1))


def merge_heads(x: torch.Tensor, batch: int) -> torch.Tensor:
    """[B*H, T, d] -> [B, T, H*d]."""
    n, t, d = x.shape
    return x.reshape(batch, n // batch, t, d).transpose(1, 2).reshape(batch, t, -1)


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

def _wmma_smem(d: int) -> Tuple[int, int, int]:
    """Shared memory of PR 2's WMMA bodies (``csrc/attn_wmma.cu`` Cfg):
    2 warps of 16 rows, padded pitches; (forward, dQ, dK/dV)."""
    rows = 32
    tile, acc = rows * (d + 8) * 2, rows * (d + 4) * 4
    s, p = rows * (rows + 4) * 4, rows * (rows + 8) * 2
    return (5 * tile + s + p + acc, 6 * tile + 2 * s + p + acc,
            6 * tile + 4 * rows * 4 + 2 * s + 2 * p + 2 * acc)


@functools.lru_cache(maxsize=None)
def attn_plan(batch: int, heads: int, t: int, d: int) -> dict:
    """The launch plan of K-attn-f / K-attn-b for ``[batch, t, 3*heads*d]``
    (the geometry the wrapper and the kernels agree on; the C entry points
    check the tile, stages and split they are given, and a card test holds
    the shared memory to the kernels').

    Hopper bodies (d = 64, 128): every kernel runs one block per (64-row tile,
    batch*head): the forward and the dQ kernel own q rows and stream K/V
    tiles, the dK/dV kernel owns kv rows and streams Q/dO tiles, through a
    ring of ``stages`` tiles loaded by the TMA in boxes of 64 channels x 64
    rows. The two consumer warpgroups split the streamed tiles (``split`` =
    2; 1 when there is a single tile, so that each gets one). The backward
    is two launches. WMMA bodies (d = 192, 256): PR 2's, 32-row tiles, 64
    threads, a three-launch backward."""
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {d} has no kernel (supported: {HEAD_DIMS})")
    if d in WGMMA_HEAD_DIMS:
        tiles = -(-t // ROWS)
        tile = ROWS * d * 2
        smem = {"fwd": tile + STAGES * 2 * tile + _ALIGN,
                "bwd_dq": 3 * tile + _ALIGN + STAGES * 2 * tile + _ALIGN,
                "bwd_dkdv": 2 * tile + STAGES * (2 * tile + _ALIGN) + _ALIGN}
        grid = (tiles, batch * heads)
        return dict(body="wgmma", d=d, q_tile=ROWS, kv_tile=ROWS, tiles=tiles, stages=STAGES,
                    split=2 if tiles >= 2 else 1, grid={k: grid for k in smem}, smem=smem,
                    box=(64, ROWS, 1), bwd_launches=2)
    rows = 32
    grid = (-(-t // rows), batch * heads)
    smem = dict(zip(("fwd", "bwd_dq", "bwd_dkdv"), _wmma_smem(d)))
    return dict(body="wmma", d=d, q_tile=rows, kv_tile=rows, tiles=grid[0], stages=2, split=1,
                grid={k: grid for k in smem}, smem=smem, box=None, bwd_launches=3)


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

def _bad(name: str, dev, arg: str, t: torch.Tensor, want) -> Exception:
    if t.device != dev:
        return ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
    if t.dtype != want:
        return TypeError(f"{name}: {arg} has dtype {t.dtype}; the CUDA kernel takes {want} "
                         "(run the UNet with compute_dtype bfloat16)")
    return ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")


def _check(name: str, num_heads: int, qkv: torch.Tensor, *more) -> Tuple[int, int, int, dict]:
    """One pass over the tensors (device, dtype, contiguity, 16-byte
    alignment; ``more`` = (name, tensor, dtype) triples), then qkv's shape.
    Returns (b, t, c, plan)."""
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for arg, t, want in (("qkv", qkv, torch.bfloat16), *more):
        if t.device != dev or t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
            raise _bad(name, dev, arg, t, want)
    b, t, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % num_heads:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} does not split into 3 x {num_heads} heads")
    return b, t, c, attn_plan(b, num_heads, t, c // num_heads)


def _launch(dev: torch.device, fn, *args) -> int:
    """Call a kernel's C entry point on ``dev``'s current stream (switching
    the current device only where it differs)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, _build.stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, _build.stream(dev))


def attention_fwd(qkv: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-attn-f. qkv [B, T, 3C] bf16 on a card -> (out [B, T, C] bf16,
    lse [B*H, T] f32, the per-row log-sum-exp of the scaled logits)."""
    b, t, c, plan = _check("attention_fwd", num_heads, qkv)
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * num_heads, t), dtype=torch.float32, device=qkv.device)
    lib, d = _build.library(), plan["d"]
    if plan["body"] == "wgmma":
        status = _launch(qkv.device, lib.cgd_attn_fwd, qkv.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), b, t, num_heads, d, plan["kv_tile"], plan["stages"],
                         plan["split"])
    else:
        base, es = qkv.data_ptr(), qkv.element_size()
        status = _launch(qkv.device, lib.cgd_attn_fwd_wmma, base, base + c * es,
                         base + 2 * c * es, out.data_ptr(), lse.data_ptr(), b, t, num_heads, d,
                         3 * c, c)
    _build.check(status, "attention_fwd")
    LAUNCHES["attn_fwd"] += 1
    return out, lse


def attention_bwd(qkv, out, lse, g, num_heads: int) -> torch.Tensor:
    """K-attn-b. The forward's qkv, out and lse and the cotangent g [B, T, C]
    -> dqkv [B, T, 3C] bf16 (deterministic)."""
    bf = torch.bfloat16
    b, t, c, plan = _check("attention_bwd", num_heads, qkv, ("out", out, bf),
                           ("lse", lse, torch.float32), ("g", g, bf))
    if out.shape != (b, t, c) or g.shape != (b, t, c) or lse.shape != (b * num_heads, t):
        raise ValueError("attention_bwd: out / g / lse do not fit qkv")
    # dqkv and the D scratch (f32 [B*H, T], at byte 2n: 16-byte aligned) in one
    # allocation
    n = b * t * 3 * c
    buf = torch.empty(n + 2 * b * num_heads * t, dtype=bf, device=qkv.device)
    dqkv = buf.as_strided((b, t, 3 * c), (t * 3 * c, 3 * c, 1))
    gbase = buf.data_ptr()
    dvec = gbase + 2 * n
    lib, d = _build.library(), plan["d"]
    if plan["body"] == "wgmma":
        status = _launch(qkv.device, lib.cgd_attn_bwd, qkv.data_ptr(), out.data_ptr(),
                         g.data_ptr(), lse.data_ptr(), dvec, gbase, b, t, num_heads, d,
                         plan["kv_tile"], plan["stages"], plan["split"])
    else:
        base, es = qkv.data_ptr(), qkv.element_size()
        status = _launch(qkv.device, lib.cgd_attn_bwd_wmma, base, base + c * es,
                         base + 2 * c * es, out.data_ptr(), g.data_ptr(), lse.data_ptr(), dvec,
                         gbase, gbase + c * es, gbase + 2 * c * es, b, t, num_heads, d, 3 * c,
                         c, 3 * c)
    _build.check(status, "attention_bwd")
    LAUNCHES["attn_bwd"] += 1
    return dqkv


# ---------------------------------------------------------------------------
# autograd Function (flash_mha's custom_vjp)
# ---------------------------------------------------------------------------

class _QKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.num_heads = num_heads
        if qkv.device.type == "cpu":
            ctx.save_for_backward(qkv)
            return merge_heads(attention_fwd_plain(*split_heads(qkv, num_heads)), qkv.shape[0])
        out, lse = attention_fwd(qkv, num_heads)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.saved_tensors[0].device.type == "cpu":
            (qkv,) = ctx.saved_tensors
            b, h = qkv.shape[0], ctx.num_heads
            grads = attention_bwd_plain(*split_heads(qkv, h), to_heads(g, h))
            return torch.cat([merge_heads(z, b) for z in grads], dim=-1), None
        qkv, out, lse = ctx.saved_tensors
        return attention_bwd(qkv, out, lse, g.contiguous(), ctx.num_heads), None


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention of a fused [B, T, 3C] qkv laid out [q_heads | k_heads |
    v_heads] -> [B, T, C]: K-attn-f forward, K-attn-b backward on a card; the
    plain versions on the CPU."""
    return _QKVAttention.apply(qkv, num_heads)
