"""The ADM UNet of OpenAI's guided-diffusion (``unet.py``: ``UNetModel``
with ``resblock_updown``, ``use_scale_shift_norm``, learned sigma and the
legacy QKV attention order), plain PyTorch in float32, under the published
checkpoints' parameter names (``input_blocks.1.0.in_layers.0.weight``...).
Written from the architecture, not from the port; it imports nothing of it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.layers import (
    F32,
    Conv1x1d,
    Conv2d,
    Embedding,
    GroupNorm32,
    Linear,
    Operands,
)

# guided-diffusion's script_util.create_model channel multipliers
CHANNEL_MULT = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4),
                64: (1, 2, 3, 4)}


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_dim, mode, ops: Operands):
        super().__init__()
        self.mode = mode
        self.in_layers = nn.Sequential(GroupNorm32(cin), nn.SiLU(),
                                       Conv2d(cin, cout, 3, ops, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, 2 * cout, ops))
        self.out_layers = nn.Sequential(GroupNorm32(cout), nn.SiLU(), nn.Identity(),
                                        Conv2d(cout, cout, 3, ops, padding=1))
        self.skip_connection = Conv2d(cin, cout, 1, ops) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers[1](self.in_layers[0](x))
        if self.mode == "up":
            h, x = (F.interpolate(z, scale_factor=2, mode="nearest") for z in (h, x))
        elif self.mode == "down":
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers(emb)[:, :, None, None].chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = self.out_layers[3](self.out_layers[1](h))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Legacy order: the qkv rows are [head][q|k|v][d]."""

    def __init__(self, ch, heads, ops: Operands):
        super().__init__()
        self.heads, self.ops = heads, ops
        self.norm = GroupNorm32(ch)
        self.qkv = Conv1x1d(ch, 3 * ch, ops)
        self.proj_out = Conv1x1d(ch, ch, ops)

    def forward(self, x, emb=None):
        b, c, hh, ww = x.shape
        flat = x.reshape(b, c, hh * ww)
        qkv = self.qkv(self.norm(flat)).reshape(b * self.heads, 3 * c // self.heads, hh * ww)
        q, k, v = qkv.chunk(3, dim=1)  # [b*H, d, T]
        s = 1.0 / math.sqrt(math.sqrt(q.shape[1]))
        w = torch.softmax(self.ops(torch.einsum("bct,bcs->bts", self.ops(q * s), self.ops(k * s))),
                          dim=-1)
        a = self.ops(torch.einsum("bts,bcs->bct", self.ops(w), self.ops(v))).reshape(b, c, hh * ww)
        return (flat + self.proj_out(a)).reshape(b, c, hh, ww)


class ADMUNet(nn.Module):
    """``flags``: the published model flags (``num_channels``,
    ``num_res_blocks``, ``attention_resolutions``, ``num_head_channels``,
    ``class_cond``, ``learn_sigma``, ``image_size``, optional
    ``channel_mult``)."""

    def __init__(self, flags: dict, ops: Operands = F32):
        super().__init__()
        size, mc = flags["image_size"], flags["num_channels"]
        mult = tuple(flags.get("channel_mult") or CHANNEL_MULT[size])
        attn_ds = {size // int(r) for r in str(flags["attention_resolutions"]).split(",")}
        nrb, head_ch = flags["num_res_blocks"], flags.get("num_head_channels", -1)
        emb_dim = 4 * mc
        self.mc = mc
        out_ch = 6 if flags.get("learn_sigma", True) else 3

        def heads(ch):
            return ch // head_ch if head_ch != -1 else flags.get("num_heads", 1)

        def attn(ch):
            return AttentionBlock(ch, heads(ch), ops)

        self.time_embed = nn.Sequential(Linear(mc, emb_dim, ops), nn.SiLU(),
                                        Linear(emb_dim, emb_dim, ops))
        self.label_emb = Embedding(1000, emb_dim) if flags.get("class_cond") else None
        ch = int(mult[0] * mc)
        blocks = [nn.ModuleList([Conv2d(3, ch, 3, ops, padding=1)])]
        chans, ds = [ch], 1
        for level, m in enumerate(mult):
            for _ in range(nrb):
                layers = [ResBlock(ch, int(m * mc), emb_dim, "", ops)]
                ch = int(m * mc)
                if ds in attn_ds:
                    layers.append(attn(ch))
                blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(mult) - 1:
                blocks.append(nn.ModuleList([ResBlock(ch, ch, emb_dim, "down", ops)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb_dim, "", ops), attn(ch),
                                           ResBlock(ch, ch, emb_dim, "", ops)])
        blocks = []
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(nrb + 1):
                layers = [ResBlock(ch + chans.pop(), int(m * mc), emb_dim, "", ops)]
                ch = int(m * mc)
                if ds in attn_ds:
                    layers.append(attn(ch))
                if level and i == nrb:
                    layers.append(ResBlock(ch, ch, emb_dim, "up", ops))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(ch, out_ch, 3, ops, padding=1))

    def forward(self, x, t, y=None):
        """x [B, 3, H, W], t [B] (model time), y [B] labels -> [B, 6, H, W]."""
        emb = self.time_embed(timestep_embedding(t, self.mc))
        if self.label_emb is not None:
            emb = emb + self.label_emb(y)
        hs, h = [], x
        for blk in self.input_blocks:
            for layer in blk:
                h = layer(h, emb) if isinstance(layer, (ResBlock, AttentionBlock)) else layer(h)
            hs.append(h)
        for layer in self.middle_block:
            h = layer(h, emb)
        for blk in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for layer in blk:
                h = layer(h, emb)
        return self.out(h)
