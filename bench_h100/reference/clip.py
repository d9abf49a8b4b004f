"""OpenAI CLIP (``clip/model.py``): the ViT and ModifiedResNet image towers
and the text transformer, plain PyTorch in float32 under the published
state dict's names (``visual.transformer.resblocks.0.attn.in_proj_weight``,
``visual.layer1.0.downsample.0.weight``, ``token_embedding.weight``...).
Images come in NCHW, already normalised with CLIP's mean and std.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.layers import (
    F32,
    BatchNorm2d,
    Conv2d,
    Embedding,
    LayerNorm,
    Linear,
    Operands,
    _param,
    attention,
)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight`` [3C, C],
    ``in_proj_bias``, ``out_proj``) over [B, T, C]."""

    def __init__(self, width: int, heads: int, ops: Operands):
        super().__init__()
        self.heads, self.ops = heads, ops
        self.in_proj_weight = _param(3 * width, width)
        self.in_proj_bias = _param(3 * width)
        self.out_proj = Linear(width, width, ops)

    def forward(self, x, mask=None):
        b, t, c = x.shape
        qkv = self.ops(self.ops(x) @ self.ops(self.in_proj_weight).t() + self.in_proj_bias)
        q, k, v = (z.reshape(b, t, self.heads, -1).transpose(1, 2) for z in qkv.split(c, -1))
        o = attention(q, k, v, self.ops, mask).transpose(1, 2).reshape(b, t, c)
        return self.out_proj(o)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, ops: Operands):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, heads, ops)
        self.ln_2 = LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", Linear(width, 4 * width, ops)),
                                              ("gelu", QuickGELU()),
                                              ("c_proj", Linear(4 * width, width, ops))]))

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, ops: Operands):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, ops) for _ in range(layers))

    def forward(self, x, mask=None):
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, res: int, patch: int, width: int, layers: int, heads: int, embed: int,
                 ops: Operands):
        super().__init__()
        self.ops = ops
        self.conv1 = Conv2d(3, width, patch, ops, stride=patch, bias=False)
        self.class_embedding = _param(width)
        self.positional_embedding = _param((res // patch) ** 2 + 1, width)
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, ops)
        self.ln_post = LayerNorm(width)
        self.proj = _param(width, embed)

    def forward(self, x):
        h = self.conv1(x).flatten(2).transpose(1, 2)  # [B, grid^2, width]
        cls = self.class_embedding.expand(h.shape[0], 1, -1)
        h = self.ln_pre(torch.cat([cls, h], dim=1) + self.positional_embedding)
        h = self.ln_post(self.transformer(h)[:, 0])
        return self.ops(self.ops(h) @ self.ops(self.proj))


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, ops: Operands):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1, ops, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, ops, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, ops, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", Conv2d(inplanes, planes * 4, 1, ops, bias=False)),
                ("1", BatchNorm2d(planes * 4))]))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial: int, c: int, heads: int, embed: int, ops: Operands):
        super().__init__()
        self.heads, self.ops = heads, ops
        self.positional_embedding = _param(spacial ** 2 + 1, c)
        self.q_proj = Linear(c, c, ops)
        self.k_proj = Linear(c, c, ops)
        self.v_proj = Linear(c, c, ops)
        self.c_proj = Linear(c, embed, ops)

    def forward(self, x):
        b, c = x.shape[:2]
        t = x.flatten(2).transpose(1, 2)  # [B, HW, C]
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1) + self.positional_embedding

        def heads(z):
            return z.reshape(b, z.shape[1], self.heads, -1).transpose(1, 2)

        o = attention(heads(self.q_proj(t[:, :1])), heads(self.k_proj(t)), heads(self.v_proj(t)),
                      self.ops)
        return self.c_proj(o.transpose(1, 2).reshape(b, c))


class ModifiedResNet(nn.Module):
    def __init__(self, layers, width: int, res: int, heads: int, embed: int, ops: Operands):
        super().__init__()
        self.conv1 = Conv2d(3, width // 2, 3, ops, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, ops, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, ops, padding=1, bias=False)
        self.bn3 = BatchNorm2d(width)
        inplanes = width
        for i, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
            planes = width * 2 ** i
            stage = [Bottleneck(inplanes, planes, stride, ops)]
            inplanes = planes * 4
            stage += [Bottleneck(inplanes, planes, 1, ops) for _ in range(blocks - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))
        self.attnpool = AttentionPool2d(res // 32, width * 32, heads, embed, ops)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = F.avg_pool2d(F.relu(self.bn3(self.conv3(h))), 2)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.attnpool(h)


class CLIPModel(nn.Module):
    """``cfg``: the configuration file's ``clip`` group: ``embed_dim``,
    ``vision`` (``kind`` "vit" with ``resolution``, ``patch``, ``width``,
    ``layers``, ``heads``; or "resnet" with ``resolution``, ``width``,
    ``layers`` [4], ``heads``) and ``text`` (``context_length``,
    ``vocab_size``, ``width``, ``heads``, ``layers``)."""

    def __init__(self, cfg: dict, ops: Operands = F32):
        super().__init__()
        v, t, embed = cfg["vision"], cfg["text"], cfg["embed_dim"]
        if v["kind"] == "vit":
            self.visual = VisionTransformer(v["resolution"], v["patch"], v["width"], v["layers"],
                                            v["heads"], embed, ops)
        else:
            self.visual = ModifiedResNet(tuple(v["layers"]), v["width"], v["resolution"],
                                         v["heads"], embed, ops)
        self.ops = ops
        self.token_embedding = Embedding(t["vocab_size"], t["width"])
        self.positional_embedding = _param(t["context_length"], t["width"])
        self.transformer = Transformer(t["width"], t["layers"], t["heads"], ops)
        self.ln_final = LayerNorm(t["width"])
        self.text_projection = _param(t["width"], embed)

    def encode_text(self, tokens):
        ctx = tokens.shape[1]
        mask = torch.full((ctx, ctx), float("-inf"), device=tokens.device).triu(1)
        h = self.token_embedding(tokens) + self.positional_embedding
        h = self.ln_final(self.transformer(h, mask))
        h = h[torch.arange(h.shape[0], device=h.device), tokens.argmax(dim=-1)]
        return self.ops(self.ops(h) @ self.ops(self.text_projection))
