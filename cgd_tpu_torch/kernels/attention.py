"""Multi-head self-attention on Hopper: K-attn-f and K-attn-b, their plain
PyTorch versions, and the autograd Function the UNet calls.

Counterpart of ``cgd_tpu/kernels/attention_pallas.py``. Two hand-written CUDA
kernels (``csrc/attn_fwd.cu``, ``csrc/attn_bwd.cu``) replace its two Pallas
kernels: a flash-attention forward that also writes the per-row
log-sum-exp, and a deterministic backward that recomputes P from it.

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

import math
from typing import Tuple

import torch

from cgd_tpu_torch.kernels import _build

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {"attn_fwd": 0, "attn_bwd": 0}

HEAD_DIMS = (64, 128, 192, 256)  # the kernels' templates (csrc/attn_common.cuh)


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
# kernel launchers
# ---------------------------------------------------------------------------

def _check(name: str, num_heads: int, **tensors) -> Tuple[int, int, int, int]:
    qkv = tensors["qkv"]
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {qkv.device}")
    for arg, t in tensors.items():
        if t.device != qkv.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {qkv.device}")
        want = torch.float32 if arg == "lse" else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}; the CUDA kernel takes {want} "
                            "(run the UNet with compute_dtype bfloat16)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    b, t, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % num_heads:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} does not split into 3 x {num_heads} heads")
    d = c // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} has no kernel (supported: {HEAD_DIMS})")
    return b, t, c, d


def attention_fwd(qkv: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-attn-f. qkv [B, T, 3C] bf16 on a card -> (out [B, T, C] bf16,
    lse [B*H, T] f32, the per-row log-sum-exp of the scaled logits)."""
    b, t, c, d = _check("attention_fwd", num_heads, qkv=qkv)
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * num_heads, t), dtype=torch.float32, device=qkv.device)
    base, es = qkv.data_ptr(), qkv.element_size()
    with torch.cuda.device(qkv.device):
        status = _build.library().cgd_attn_fwd(
            base, base + c * es, base + 2 * c * es, out.data_ptr(), lse.data_ptr(),
            b, t, num_heads, d, 3 * c, c, _build.stream(qkv.device))
    _build.check(status, "attention_fwd")
    LAUNCHES["attn_fwd"] += 1
    return out, lse


def attention_bwd(qkv, out, lse, g, num_heads: int) -> torch.Tensor:
    """K-attn-b. The forward's qkv, out and lse and the cotangent g [B, T, C]
    -> dqkv [B, T, 3C] bf16 (deterministic)."""
    b, t, c, d = _check("attention_bwd", num_heads, qkv=qkv, out=out, lse=lse, g=g)
    if out.shape != (b, t, c) or g.shape != (b, t, c) or lse.shape != (b * num_heads, t):
        raise ValueError("attention_bwd: out / g / lse do not fit qkv")
    dqkv = torch.empty_like(qkv)
    dvec = torch.empty_like(lse)
    base, gbase, es = qkv.data_ptr(), dqkv.data_ptr(), qkv.element_size()
    with torch.cuda.device(qkv.device):
        status = _build.library().cgd_attn_bwd(
            base, base + c * es, base + 2 * c * es, out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), gbase, gbase + c * es, gbase + 2 * c * es,
            b, t, num_heads, d, 3 * c, c, 3 * c, _build.stream(qkv.device))
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
