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

Kernel routing: by default every 3x3 stride-1 pad-1 conv goes through the
conv family of ``cgd_tpu_torch.kernels.conv3x3`` and the UNet's attention
through ``cgd_tpu_torch.kernels.attention`` (hand-written CUDA kernels on a
CUDA tensor, their plain versions on a CPU tensor), the ResBlock chain
GroupNorm -> SiLU -> conv is fused into the conv kernel's load prologue, and
the CLIP ResNet's folded BatchNorm -> [residual add] -> ReLU runs on K-bn
(``cgd_tpu_torch.kernels.bn_act``) on a CUDA tensor.
``kernel_routing("plain")`` forces the unfused PyTorch chains of the JAX
package's defaults (cuDNN convs, the einsum/softmax attention and the
BatchNorm's f32 island on the card); it exists to compare the kernels with
PyTorch's own ops. The default equals the JAX package with
``CGD_TPU_PALLAS_ATTN=1``.

Height-split activations (``cgd_tpu_torch.parallel.mesh.Split``, the
counterpart of the JAX package's ``spatial_sharding``) are taken by the conv
ops, GroupNorm, the fused chain, the resamples and ``cat_channels``: the 3x3
convs run on ``kernels.conv_spmd`` (K-halo) on the kernel route and as the
plain halo conv under ``kernel_routing("plain")`` (the counterpart of
``CGD_TPU_PALLAS_CONV_SPMD=0``); GroupNorm statistics are combined over the
shards; ``up``/``down`` stay unfused on a split, as the JAX package forces.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from cgd_tpu_torch.kernels import attention as kattn
from cgd_tpu_torch.kernels import bn_act as kbn
from cgd_tpu_torch.kernels import conv3x3 as k3
from cgd_tpu_torch.kernels import conv_spmd
from cgd_tpu_torch.parallel.mesh import Split, split_activation

_routing_override: Optional[str] = None  # see kernel_routing()


@contextlib.contextmanager
def kernel_routing(mode: Optional[str]):
    """Force the routing of the convs, the attention and the ResNet's
    BatchNorm for the dynamic extent: ``"plain"`` (unfused PyTorch ops:
    F.conv2d, einsum/softmax, the f32 island) or ``None`` (the default: the
    kernels). Process-local and restored on exit."""
    global _routing_override
    if mode not in (None, "plain"):
        raise ValueError(f"kernel_routing mode must be None or 'plain', got {mode!r}")
    prev = _routing_override
    _routing_override = mode
    try:
        yield
    finally:
        _routing_override = prev


def _kernel_route() -> bool:
    return _routing_override is None


def silu(x: torch.Tensor) -> torch.Tensor:
    return x.map(F.silu) if isinstance(x, Split) else F.silu(x)


def _scale_shift(h, scale, shift):
    """h * (1 + scale) + shift with per-sample [B, 1, 1, C] scale / shift."""
    if isinstance(h, Split):
        return h.map_rows(_scale_shift, scale, shift)
    return h * (1.0 + scale) + shift


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

def _on(p, dev: torch.device, place):
    """The parameter leaves of ``p`` on ``dev``."""
    return SimpleNamespace(**{k: place(v, dev) for k, v in p.named_parameters(recurse=False)})


def _conv2d_split(p, x: Split, stride: int, padding) -> Split:
    kh, kw = p.kernel.shape[0], p.kernel.shape[1]
    pad = padding if padding is not None else ((kh // 2, kh // 2), (kw // 2, kw // 2))
    place = x.mesh.place
    if (kh, kw) == (1, 1) and stride == 1 and pad == ((0, 0), (0, 0)):
        return x.map(lambda t: conv2d(_on(p, t.device, place), t))
    if (kh, kw) != (3, 3) or stride != 1 or pad != ((1, 1), (1, 1)):
        return x.gathered(lambda t: conv2d(p, t, stride, padding))
    if _kernel_route():
        kernel, bias = p.kernel.to(x.dtype), p.bias.to(x.dtype)
        return Split([conv_spmd.conv3x3(row, kernel, bias, place) for row in x.shards], x.mesh)
    out = []
    for row in x.shards:  # the plain halo conv: neighbour rows stacked on H, H pad 0
        etop, ebot = conv_spmd.halo_rows([t[:, :1] for t in row], [t[:, -1:] for t in row])
        out.append([conv2d(_on(p, t.device, place), torch.cat([et, t, eb], dim=1),
                           padding=((0, 0), (1, 1)))
                    for t, et, eb in zip(row, etop, ebot)])
    return Split(out, x.mesh)


def conv2d(p, x: torch.Tensor, stride: int = 1, padding=None) -> torch.Tensor:
    """NHWC conv with HWIO weights; output in x's dtype. Default padding is
    symmetric k//2 per side (torch Conv2d semantics)."""
    if isinstance(x, Split):
        return _conv2d_split(p, x, stride, padding)
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


def _gn_stats_split(x: Split, num_groups: int, eps: float):
    """``_gn_stats`` of each data group of a split activation, on the
    group's first device: the per-shard f32 sums and squared norms are
    added over the shards, so every shard is normalised by the statistics of
    the whole image."""
    stats = []
    for row in x.shards:
        home, s, q, n = row[0].device, 0.0, 0.0, 0
        for t in row:
            g = t.reshape(t.shape[0], -1, num_groups, t.shape[-1] // num_groups)
            s = s + g.sum(dim=(1, 3), keepdim=True, dtype=torch.float32).to(home)
            q = q + torch.linalg.vector_norm(g, 2, dim=(1, 3), keepdim=True,
                                             dtype=torch.float32).square().to(home)
            n += g.shape[1] * g.shape[3]
        mean = s / n
        var = (q / n - mean.square()).clamp_min(0.0)
        stats.append((mean, torch.rsqrt(var + eps)))
    return stats


def _gn_apply(p, x: torch.Tensor, mean, inv, num_groups: int) -> torch.Tensor:
    c = x.shape[-1]
    g = x.reshape(x.shape[0], -1, num_groups, c // num_groups).float()
    out = ((g - mean) * inv).reshape(x.shape)
    out = out * p.scale.float() + p.bias.float()
    return out.to(x.dtype)


def group_norm(p, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-last input; statistics and arithmetic in f32,
    output in x's dtype."""
    num_groups = _gn_groups(x.shape[-1], num_groups)
    if isinstance(x, Split):
        place = x.mesh.place
        return Split([[_gn_apply(_on(p, t.device, place), t, mean.to(t.device), inv.to(t.device),
                                 num_groups) for t in row]
                      for row, (mean, inv) in zip(x.shards, _gn_stats_split(x, num_groups, eps))],
                     x.mesh)
    mean, inv = _gn_stats(x, num_groups, eps)
    return _gn_apply(p, x, mean, inv, num_groups)


def _fold_ab(norm_p, mean, inv, scale_shift, b: int, c: int, groups: int):
    """GroupNorm apply + emb scale-shift as per-(batch, channel) f32 A/B
    (act = silu(x*A + B))."""
    rep = c // groups
    # A = inv*gamma, B = beta - mean*A per channel, broadcast over [B, G, C/G]
    A = inv.reshape(b, groups, 1) * norm_p.scale.float().reshape(groups, rep)
    B = (norm_p.bias.float().reshape(groups, rep) - mean.reshape(b, groups, 1) * A).reshape(b, c)
    A = A.reshape(b, c)
    if scale_shift is not None:
        s1 = 1.0 + scale_shift[0].reshape(b, c).float()
        A = A * s1
        B = B * s1 + scale_shift[1].reshape(b, c).float()
    return A.contiguous(), B.contiguous()


def _fused_split(norm_p, conv_p, x: Split, scale_shift, skip, num_groups, eps) -> Split:
    place, c = x.mesh.place, x.shape[-1]
    groups = _gn_groups(c, num_groups)
    wk, bias = conv_p.kernel.to(x.dtype), conv_p.bias.to(x.dtype)
    out = []
    for d, (row, (mean, inv)) in enumerate(zip(x.shards, _gn_stats_split(x, groups, eps))):
        home = row[0].device
        ss = None if scale_shift is None else [place(x.rows(t, d), home) for t in scale_shift]
        A, B = _fold_ab(_on(norm_p, home, place), mean, inv, ss, row[0].shape[0], c, groups)
        if skip is None:
            out.append(conv_spmd.conv3x3_gn_silu(row, A, B, wk, bias, place))
        else:
            skips = [t.to(x.dtype).contiguous() for t in skip.shards[d]]
            out.append(conv_spmd.conv3x3_gn_silu_add(row, A, B, wk, bias, skips, place))
    return Split(out, x.mesh)


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
    ``kernel_routing("plain")`` the whole chain is unfused PyTorch. A split
    ``x`` (with a split ``skip``) runs on K-halo with global statistics.
    """
    split = isinstance(x, Split)
    if not _kernel_route() or resample == "down" or (split and resample):
        h = group_norm(norm_p, x, num_groups, eps)
        if scale_shift is not None:
            h = _scale_shift(h, *scale_shift)
        h = silu(h)
        if resample == "down":
            h = avg_pool_2x(h)
        elif resample == "up":
            h = upsample_nearest_2x(h)
        out = conv2d(conv_p, h)
        return out + skip if skip is not None else out
    if split:
        return _fused_split(norm_p, conv_p, x, scale_shift, skip, num_groups, eps)

    b, c = x.shape[0], x.shape[-1]
    groups = _gn_groups(c, num_groups)
    mean, inv = _gn_stats(x, groups, eps)  # [B,1,G,1] f32
    A, B = _fold_ab(norm_p, mean, inv, scale_shift, b, c, groups)
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
    if isinstance(x, Split):
        return x.map(k3._up2)
    return k3._up2(x)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool: f32 sum, cast back, then * 0.25 in x's dtype. A
    split activation pools shard by shard, or, into a level whose height the
    'cut' axis does not divide, whole (the level runs unsplit)."""
    if isinstance(x, Split):
        if (x.shape[1] // 2) % x.mesh.shape["cut"]:
            return avg_pool_2x(x.gather())
        return x.map(avg_pool_2x)
    b, h, w, c = x.shape
    s = x.float().reshape(b, h // 2, 2, w // 2, 2, c).sum((2, 4))
    return s.to(x.dtype) * 0.25


def bn_relu(p, x: torch.Tensor, identity: Optional[torch.Tensor] = None,
            down=None) -> torch.Tensor:
    """relu(bn(x)), relu(bn(x) + identity), or relu(bn(x) + down_bn(identity))
    given ``down`` (the down-projection's BatchNorm): the folded (inference)
    BatchNorm ``x*scale + bias`` in f32, cast back, as the CLIP ResNet runs
    it. K-bn on a CUDA tensor on the kernel route, the PyTorch chain on a CPU
    tensor or under ``kernel_routing("plain")``; the same bits either way."""
    ds, db = (None, None) if down is None else (down.scale, down.bias)
    if _kernel_route() and x.is_cuda:
        return kbn.bn_act(x, p.scale, p.bias, identity, ds, db)
    return kbn.bn_act_plain(x, p.scale, p.bias, identity, ds, db)


def cat_channels(a, b):
    """Concatenate on the channel axis (the UNet's skip connections),
    shard by shard for split activations; a whole one beside a split one
    (up from a level that runs unsplit) is split like it first."""
    if isinstance(a, Split) != isinstance(b, Split):
        mesh = (a if isinstance(a, Split) else b).mesh
        a, b = (z if isinstance(z, Split) else split_activation(z, mesh) for z in (a, b))
    if isinstance(a, Split):
        return a.zip_map(b, lambda u, v: torch.cat([u, v], dim=-1))
    return torch.cat([a, b], dim=-1)


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head self-attention from a fused [B, T, 3C] qkv laid out
    [q_heads | k_heads | v_heads]; q and k each scaled by d^-1/4. Returns
    [B, T, C]. The kernel route is K-attn-f / K-attn-b (f32 softmax, as the
    JAX package's Pallas kernel); the plain route is the JAX default chain
    (softmax in f32 cast back to qkv's dtype before the product with v)."""
    if _kernel_route():
        return kattn.qkv_attention(qkv, num_heads)
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = (z.reshape(b, t, num_heads, d).transpose(1, 2) for z in qkv.split(c, dim=-1))
    scale = 1.0 / math.sqrt(math.sqrt(d))
    logits = (q * scale) @ (k * scale).transpose(-1, -2)
    weights = torch.softmax(logits.float(), dim=-1).to(qkv.dtype)
    out = (weights @ v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, t, c)
