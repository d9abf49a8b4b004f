"""Plain PyTorch layers of the reference, NCHW, weights in the published
layouts (``[out, in, kh, kw]`` convs, ``[out, in]`` linears), float32.

Every product of two tensors (conv, linear, attention) passes both operands
and its result through ``ops``, an ``Operands`` object: float32 leaves them
as they are; ``fp8`` rounds each to float8 e4m3 with a per-tensor scale
(its largest magnitude mapped to 448) and passes gradients through
unrounded. With ``round_outputs`` every layer's output is rounded too, as a
model computed in fp8 holds its activations where the program holds them
in bfloat16: the precision step below the one the configurations state.
That is the control of the benchmark's comparison.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


class Operands:
    """How the operands of every product are rounded: ``float32`` (as they
    are) or ``fp8`` (float8 e4m3, per-tensor amax scale)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: float32 or fp8")
        self.precision = precision

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return t
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = E4M3_MAX / amax
        q = (t * scale).clamp(-E4M3_MAX, E4M3_MAX)  # e4m3fn has no infinity: past 448 is NaN
        rounded = q.to(torch.float8_e4m3fn).to(t.dtype) / scale
        # the rounded value forward; the gradient passes straight through in
        # float32 (a float8 cast's own backward would round the gradient too)
        return t + (rounded - t).detach()


F32 = Operands("float32")


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, ops: Operands, bias: bool = True):
        super().__init__()
        self.ops = ops
        self.weight = _param(cout, cin)
        self.bias = _param(cout) if bias else None

    def forward(self, x):
        out = self.ops(x) @ self.ops(self.weight).t()
        return self.ops(out + self.bias if self.bias is not None else out)


class Conv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, ops: Operands, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.ops, self.stride, self.padding = ops, stride, padding
        self.weight = _param(cout, cin, k, k)
        self.bias = _param(cout) if bias else None

    def forward(self, x):
        return self.ops(F.conv2d(self.ops(x), self.ops(self.weight), self.bias, self.stride,
                                 self.padding))


class Conv1x1d(nn.Module):
    """The published ADM attention's ``conv_nd(1, ...)``: weight [out, in, 1]."""

    def __init__(self, cin: int, cout: int, ops: Operands):
        super().__init__()
        self.ops = ops
        self.weight = _param(cout, cin, 1)
        self.bias = _param(cout)

    def forward(self, x):  # [B, C, T]
        return self.ops(torch.einsum("oc,bct->bot", self.ops(self.weight[:, :, 0]), self.ops(x))
                        + self.bias[None, :, None])


class GroupNorm32(nn.Module):
    def __init__(self, ch: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = _param(ch)
        self.bias = _param(ch)

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(ch)
        self.bias = _param(ch)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class BatchNorm2d(nn.Module):
    """Inference BatchNorm from its running statistics."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(ch)
        self.bias = _param(ch)
        self.register_buffer("running_mean", torch.empty(ch))
        self.register_buffer("running_var", torch.empty(ch))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = _param(num, dim)

    def forward(self, idx):
        return self.weight[idx]


def attention(q, k, v, ops: Operands, mask=None):
    """softmax(q k^T / sqrt(d)) v over [..., T, d], the softmax in f32."""
    logits = ops(ops(q) @ ops(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits + mask
    return ops(ops(torch.softmax(logits, dim=-1)) @ ops(v))


def round_outputs(model: nn.Module, ops: Operands) -> None:
    """Every module's tensor output through ``ops`` (norms, activations,
    residual sums, blocks): the activations held in ``ops``' precision."""
    def hook(module, inputs, output):
        return ops(output) if torch.is_tensor(output) else output

    for m in model.modules():
        m.register_forward_hook(hook)
