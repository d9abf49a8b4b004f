"""The CLIP ResNet tower's folded BatchNorm, residual add and ReLU in one
pass each way: K-bn (``csrc/bn_act.cu``), its plain PyTorch versions, and
the autograd Function the tower calls.

The JAX package runs this chain as XLA ops (``cgd_tpu/models/clip/model.py``:
the BatchNorm folded into ``x * scale + bias`` in an f32 island, cast back,
then the residual add and the ReLU). In PyTorch each of those is a kernel of
its own, a pass over the activation each: at RN50x16's 123 sites a guided
step ran some 1,000 of them. K-bn does the same arithmetic with the same
roundings in one launch forward and one backward, in three modes:

- ``"a"``: ``relu(T(x*s + b))`` (the stem, and each bottleneck's bn1, bn2);
- ``"b"``: ``relu(T(T(x*s + b) + r))`` with the identity ``r`` (bn3);
- ``"c"``: as ``"b"`` with ``r = T(d*sd + bd)``, the down-projection's
  BatchNorm of ``d`` (each stage's first bottleneck);

where ``x*s + b`` is an f32 multiply then an f32 add and T the activation's
dtype (bf16 or f32). Backward reads the saved ``y`` only:
``g = dy where y > 0 else 0``, ``dx = T(g*s)``, and for the identity ``g``
(``"b"``) or ``T(g*sd)`` (``"c"``). Both are bit-equal to the chain's
forward and autograd's backward of it.

Dispatch: a CUDA tensor launches the kernel; a CPU tensor runs the plain
versions (``bn_act_plain``, the chain itself, and ``bn_act_bwd_plain``,
its backward written out). The scale and bias are constants (the towers'
parameters are frozen): the gradient reaches the activations only. Each
launch is counted in ``LAUNCHES`` by direction and mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cgd_tpu_torch.kernels import _build
from cgd_tpu_torch.kernels import conv3x3

# launches of each direction and mode since the last reset_launch_counts()
# (a replayed CUDA graph adds what its capture counted: launch_counters)
LAUNCHES = {f"bn_act_{way}_{mode}": 0 for way in ("fwd", "bwd") for mode in "abc"}

_MODES = {"a": 0, "b": 1, "c": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mode(identity, down_scale) -> str:
    if identity is None:
        return "a"
    return "b" if down_scale is None else "c"


def _affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The folded BatchNorm: x*scale + bias in f32, cast back."""
    return (x.float() * scale + bias).to(x.dtype)


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 identity: Optional[torch.Tensor] = None,
                 down_scale: Optional[torch.Tensor] = None,
                 down_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(bn(x) [+ identity or bn_down(identity)]): the chain K-bn
    replaces, as PyTorch ops (differentiable by autograd)."""
    out = _affine(x, scale, bias)
    if identity is not None:
        if down_scale is not None:
            identity = _affine(identity, down_scale, down_bias)
        out = out + identity
    return F.relu(out)


def bn_act_bwd_plain(y: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                     mode: str, down_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chain's backward from its output y: (dx, d identity), the second
    None in mode "a"."""
    g = torch.ops.aten.threshold_backward(dy, y, 0)
    dx = (g.float() * scale).to(y.dtype)
    if mode == "a":
        return dx, None
    return dx, g if mode == "b" else (g.float() * down_scale).to(y.dtype)


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill its storage span with no gap or overlap
    (some permutation of a contiguous tensor; size-1 dims ignored)."""
    expected = 1
    for size, stride in sorted(((n, s) for n, s in zip(t.shape, t.stride()) if n > 1),
                               key=lambda d: d[1]):
        if stride != expected:
            return False
        expected *= size
    return True


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """t in ref's layout (a copy only where they differ)."""
    return t if _same_layout(t, ref) else torch.empty_like(ref).copy_(t)


def _check(name: str, x: torch.Tensor, **factors) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: activations must be bfloat16 or float32, got {x.dtype}")
    c = x.shape[-1]
    for k, t in factors.items():
        if t is not None and (t.device != dev or t.dtype != torch.float32 or t.shape != (c,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {k} must be a contiguous float32 [{c}] tensor on {dev}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _geometry(t: torch.Tensor) -> Tuple[int, int, int]:
    """(elements, channels, the channel's stride) of a dense tensor whose
    last dim is the channel."""
    c = t.shape[-1]
    return t.numel(), c, t.stride(-1) if c > 1 else 1


def bn_act_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               identity: Optional[torch.Tensor] = None,
               down_scale: Optional[torch.Tensor] = None,
               down_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K-bn's forward on a card, the plain chain on the CPU. y has x's
    layout."""
    if x.device.type == "cpu":
        return bn_act_plain(x, scale, bias, identity, down_scale, down_bias)
    mode = _mode(identity, down_scale)
    _check("bn_act", x, scale=scale, bias=bias, down_scale=down_scale, down_bias=down_bias)
    if not _dense(x):
        x = x.contiguous()
    if identity is not None:
        if identity.shape != x.shape or identity.dtype != x.dtype:
            raise ValueError(f"bn_act: identity must be {x.dtype} {tuple(x.shape)}; got "
                             f"{identity.dtype} {tuple(identity.shape)}")
        identity = _like(identity, x)
    y = torch.empty_like(x)
    n, c, inner = _geometry(x)
    if n == 0:
        return y
    dev = x.device
    with torch.cuda.device(dev):
        status = _build.library().cgd_bn_act_fwd(
            x.data_ptr(), None if identity is None else identity.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), None if down_scale is None else down_scale.data_ptr(),
            None if down_bias is None else down_bias.data_ptr(), y.data_ptr(), n, c, inner,
            _MODES[mode], x.dtype == torch.float32, conv3x3._sms(dev), _build.stream(dev))
    _build.check(status, "bn_act")
    LAUNCHES[f"bn_act_fwd_{mode}"] += 1
    return y


def bn_act_bwd(y: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, mode: str,
               down_scale: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K-bn's backward on a card, the plain version on the CPU: (dx, d
    identity), both in y's layout, the second None in mode "a"."""
    if y.device.type == "cpu":
        return bn_act_bwd_plain(y, dy, scale, mode, down_scale)
    _check("bn_act backward", y, scale=scale, down_scale=down_scale)
    dy = _like(dy, y)
    dx = torch.empty_like(y)
    dr = None if mode == "a" else torch.empty_like(y)
    n, c, inner = _geometry(y)
    if n == 0:
        return dx, dr
    dev = y.device
    with torch.cuda.device(dev):
        status = _build.library().cgd_bn_act_bwd(
            y.data_ptr(), dy.data_ptr(), scale.data_ptr(),
            None if down_scale is None else down_scale.data_ptr(), dx.data_ptr(),
            None if dr is None else dr.data_ptr(), n, c, inner, _MODES[mode],
            y.dtype == torch.float32, conv3x3._sms(dev), _build.stream(dev))
    _build.check(status, "bn_act backward")
    LAUNCHES[f"bn_act_bwd_{mode}"] += 1
    return dx, dr


class _BnAct(torch.autograd.Function):
    """relu(bn(x) [+ identity or bn_down(identity)]); saves y alone."""

    @staticmethod
    def forward(ctx, x, scale, bias, identity, down_scale, down_bias):
        if any(t is not None and t.requires_grad for t in (scale, bias, down_scale, down_bias)):
            raise ValueError("bn_act: the folded BatchNorm's scale and bias are constants; "
                             "differentiate bn_act_plain for their gradients")
        y = bn_act_fwd(x, scale, bias, identity, down_scale, down_bias)
        ctx.mode = _mode(identity, down_scale)
        ctx.save_for_backward(y, scale, down_scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, scale, down_scale = ctx.saved_tensors
        dx, dr = bn_act_bwd(y, dy, scale, ctx.mode, down_scale)
        return dx, None, None, dr, None, None


def bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           identity: Optional[torch.Tensor] = None,
           down_scale: Optional[torch.Tensor] = None,
           down_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., C] (bf16 or f32, channels last in the shape, any dense
    layout) -> relu(bn(x)) in mode "a", relu(bn(x) + identity) in "b",
    relu(bn(x) + bn_down(identity)) in "c" (given down_scale and down_bias);
    scale, bias, down_*: f32 [C]. Differentiable in x and identity."""
    return _BnAct.apply(x, scale, bias, identity, down_scale, down_bias)
