"""Low-level neural-net ops in PyTorch, counterpart of ``cgd_tpu/ops/nn.py``.

Same conventions as the JAX package, so the two compare like with like:
- activations are channels-last NHWC, conv weights HWIO, dense weights
  ``[in, out]``;
- bf16 activations with f32 accumulation; GroupNorm and softmax run in f32
  islands and cast back;
- the same cast points: GN math in f32, the conv bias added in the compute
  dtype on the unfused path, the attention softmax cast back to the compute
  dtype.

Parameters arrive as small modules (or any object) with the JAX leaf names
as attributes: ``p.kernel``/``p.bias`` (conv, dense), ``p.scale``/``p.bias``
(GroupNorm), ``p.table`` (embedding).

Conv routing: by default every 3x3 stride-1 pad-1 conv goes through the conv
family of ``cgd_tpu_torch.kernels.conv3x3`` (hand-written CUDA kernels on a
CUDA tensor, their plain versions on a CPU tensor), and the ResBlock chain
GroupNorm -> SiLU -> conv is fused into the kernel's load prologue.
``conv_routing("plain")`` forces the unfused PyTorch chain (cuDNN convs on
the card); it exists to compare the kernels with PyTorch's own ops.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from cgd_tpu_torch.kernels import conv3x3 as k3

_conv_routing_override: Optional[str] = None  # see conv_routing()


@contextlib.contextmanager
def conv_routing(mode: Optional[str]):
    """Force conv routing for the dynamic extent: ``"plain"`` (unfused
    PyTorch ops, F.conv2d) or ``None`` (the default: the kernel family).
    Process-local and restored on exit."""
    global _conv_routing_override
    if mode not in (None, "plain"):
        raise ValueError(f"conv_routing mode must be None or 'plain', got {mode!r}")
    prev = _conv_routing_override
    _conv_routing_override = mode
    try:
        yield
    finally:
        _conv_routing_override = prev


def _kernel_route() -> bool:
    return _conv_routing_override is None


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def cast_conv_params(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast every 4-D conv kernel (and its bias) to the compute dtype, once,
    as ``cgd_tpu.ops.nn.cast_conv_params`` does. Norm parameters and dense
    layers stay as they are. In place; returns the module."""
    for m in module.modules():
        k = getattr(m, "kernel", None)
        if isinstance(k, torch.Tensor) and k.dim() == 4:
            for name, p in m.named_parameters(recurse=False):
                p.data = p.data.to(dtype)
    return module


# ---------------------------------------------------------------------------
# forward ops
# ---------------------------------------------------------------------------

def conv2d(p, x: torch.Tensor, stride: int = 1, padding=None) -> torch.Tensor:
    """NHWC conv with HWIO weights; output in x's dtype. Default padding is
    symmetric k//2 per side (torch Conv2d semantics)."""
    kernel = p.kernel.to(x.dtype)
    kh, kw = kernel.shape[0], kernel.shape[1]
    if padding is None:
        padding = ((kh // 2, kh // 2), (kw // 2, kw // 2))
    if (kh, kw) == (1, 1) and stride == 1 and padding == ((0, 0), (0, 0)):
        out = x @ kernel[0, 0]
        return out + p.bias.to(out.dtype)
    if _kernel_route() and (kh, kw) == (3, 3) and stride == 1 and padding == ((1, 1), (1, 1)):
        return k3.conv3x3(x, kernel, p.bias.to(x.dtype))
    if padding[0][0] != padding[0][1] or padding[1][0] != padding[1][1]:
        raise ValueError(f"conv2d: asymmetric padding {padding} is not supported")
    out = F.conv2d(
        x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
        stride=stride, padding=(padding[0][0], padding[1][0]),
    ).permute(0, 2, 3, 1)
    # bias in the compute dtype, as the JAX package's unfused path
    return out + p.bias.to(out.dtype)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    out = x @ p.kernel.to(x.dtype)
    return out + p.bias.to(out.dtype)


def _gn_groups(c: int, num_groups: int) -> int:
    while c % num_groups:
        num_groups //= 2
    return num_groups


def _gn_stats(x: torch.Tensor, num_groups: int, eps: float):
    """Per-(batch, group) mean and rsqrt(var + eps) in f32 from
    E[x^2] - E[x]^2, shaped [B, 1, G, 1] against x viewed [B, N, G, C/G].
    Both moments accumulate in f32 straight from x (two read-only passes, no
    f32 copy of a bf16 x); E[x^2] as the squared f32 L2 norm over n."""
    c = x.shape[-1]
    g = x.reshape(x.shape[0], -1, num_groups, c // num_groups)
    n = g.shape[1] * g.shape[3]
    mean = torch.mean(g, dim=(1, 3), keepdim=True, dtype=torch.float32)
    norm = torch.linalg.vector_norm(g, 2, dim=(1, 3), keepdim=True, dtype=torch.float32)
    var = (norm.square() / n - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def group_norm(p, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-last input; statistics and arithmetic in f32,
    output in x's dtype."""
    c = x.shape[-1]
    num_groups = _gn_groups(c, num_groups)
    mean, inv = _gn_stats(x, num_groups, eps)
    g = x.reshape(x.shape[0], -1, num_groups, c // num_groups).float()
    out = ((g - mean) * inv).reshape(x.shape)
    out = out * p.scale.float() + p.bias.float()
    return out.to(x.dtype)


def fused_gn_silu_conv(
    norm_p,
    conv_p,
    x: torch.Tensor,
    scale_shift=None,
    skip: Optional[torch.Tensor] = None,
    num_groups: int = 32,
    eps: float = 1e-5,
    resample: str = "",
) -> torch.Tensor:
    """GroupNorm -> [emb scale-shift] -> SiLU -> [avg-pool/nearest-2x] ->
    conv3x3 [+ residual].

    On the kernel route the GN apply and the scale-shift fold into
    per-(batch, channel) f32 vectors A/B (act = silu(x*A + B)) that the conv
    kernel applies while loading; ``up`` is fused too. ``down`` stays
    unfused (as in the JAX package), its conv on the kernel route. Under
    ``conv_routing("plain")`` the whole chain is unfused PyTorch.
    """
    if not _kernel_route() or resample == "down":
        h = group_norm(norm_p, x, num_groups, eps)
        if scale_shift is not None:
            h = h * (1.0 + scale_shift[0]) + scale_shift[1]
        h = silu(h)
        if resample == "down":
            h = avg_pool_2x(h)
        elif resample == "up":
            h = upsample_nearest_2x(h)
        out = conv2d(conv_p, h)
        return out + skip if skip is not None else out

    b, c = x.shape[0], x.shape[-1]
    groups = _gn_groups(c, num_groups)
    mean, inv = _gn_stats(x, groups, eps)  # [B,1,G,1] f32
    rep = c // groups
    # A = inv*gamma, B = beta - mean*A per channel, broadcast over [B, G, C/G]
    A = inv.reshape(b, groups, 1) * norm_p.scale.float().reshape(groups, rep)
    B = (norm_p.bias.float().reshape(groups, rep) - mean.reshape(b, groups, 1) * A).reshape(b, c)
    A = A.reshape(b, c)
    if scale_shift is not None:
        s1 = 1.0 + scale_shift[0].reshape(b, c).float()
        A = A * s1
        B = B * s1 + scale_shift[1].reshape(b, c).float()
    A, B = A.contiguous(), B.contiguous()
    x = x.contiguous()
    wk = conv_p.kernel.to(x.dtype)
    bias = conv_p.bias.to(x.dtype)
    if resample == "up":
        return k3.conv3x3_gn_silu_up(x, A, B, wk, bias)
    if skip is not None:
        return k3.conv3x3_gn_silu_add(x, A, B, wk, bias, skip.to(x.dtype).contiguous())
    return k3.conv3x3_gn_silu(x, A, B, wk, bias)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos|sin] order (ADM convention), f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return k3._up2(x)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool: f32 sum, cast back, then * 0.25 in x's dtype."""
    b, h, w, c = x.shape
    s = x.float().reshape(b, h // 2, 2, w // 2, 2, c).sum((2, 4))
    return s.to(x.dtype) * 0.25


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head self-attention from a fused [B, T, 3C] qkv laid out
    [q_heads | k_heads | v_heads]; q and k each scaled by d^-1/4, softmax in
    f32 cast back to qkv's dtype. Returns [B, T, C]."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = (z.reshape(b, t, num_heads, d).transpose(1, 2) for z in qkv.split(c, dim=-1))
    scale = 1.0 / math.sqrt(math.sqrt(d))
    logits = (q * scale) @ (k * scale).transpose(-1, -2)
    weights = torch.softmax(logits.float(), dim=-1).to(qkv.dtype)
    out = (weights @ v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, t, c)
