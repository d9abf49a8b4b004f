"""CLIP ViT and text towers as PyTorch modules, counterpart of
``cgd_tpu/models/clip/model.py`` (the ModifiedResNet tower is not ported
yet). Module paths follow the JAX pytree (``visual.blocks.0.attn_qkv.kernel``)
so weights carry across by name; layouts are the JAX ones (NHWC images,
``[in, out]`` dense kernels, HWIO patch kernel). LayerNorm and softmax run in
f32 islands inside bf16 activations.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cgd_tpu_torch.models.clip.configs import CLIPConfig, TextConfig, VisionViTConfig
from cgd_tpu_torch.models.unet import Dense, Norm, _empty, init_leaves
from cgd_tpu_torch.ops import nn as cnn


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class Block(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool, device=None):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.ln_1 = Norm(width, device)
        self.attn_qkv = Dense(width, 3 * width, device=device)
        self.attn_out = Dense(width, width, device=device)
        self.ln_2 = Norm(width, device)
        self.mlp_fc = Dense(width, 4 * width, device=device)
        self.mlp_proj = Dense(4 * width, width, device=device)

    def _mha(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        d = c // self.heads
        qkv = cnn.dense(self.attn_qkv, x)
        q, k, v = (z.reshape(b, t, self.heads, d).transpose(1, 2) for z in qkv.split(c, dim=-1))
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(d)
        if self.causal:
            mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = (w @ v).to(x.dtype).transpose(1, 2).reshape(b, t, c)
        return cnn.dense(self.attn_out, o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._mha(layer_norm(self.ln_1, x))
        h = quick_gelu(cnn.dense(self.mlp_fc, layer_norm(self.ln_2, x)))
        return x + cnn.dense(self.mlp_proj, h)


class _PatchKernel(nn.Module):
    """The patchify conv's HWIO kernel (no bias)."""

    def __init__(self, p: int, width: int, device=None):
        super().__init__()
        self.kernel = _empty((p, p, 3, width), device, torch.float32)


class ViT(nn.Module):
    def __init__(self, cfg: VisionViTConfig, embed_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        n_tok = (cfg.input_resolution // cfg.patch_size) ** 2 + 1
        self.conv1 = _PatchKernel(cfg.patch_size, cfg.width, device)
        self.class_embedding = _empty((cfg.width,), device, torch.float32)
        self.positional_embedding = _empty((n_tok, cfg.width), device, torch.float32)
        self.ln_pre = Norm(cfg.width, device)
        self.blocks = nn.ModuleList(
            Block(cfg.width, cfg.heads, False, device) for _ in range(cfg.layers))
        self.ln_post = Norm(cfg.width, device)
        self.proj = _empty((cfg.width, embed_dim), device, torch.float32)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_leaves(self, gen)
        scale = self.cfg.width ** -0.5
        for t in (self.conv1.kernel, self.class_embedding, self.positional_embedding, self.proj):
            t.normal_(generator=gen).mul_(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, R, R, 3] normalized images -> [B, embed_dim]. Patchify is a
        reshape and one matmul (no strided conv)."""
        p = self.cfg.patch_size
        b, r1, r2, _ = x.shape
        gh, gw = r1 // p, r2 // p
        patches = x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, gh * gw, p * p * 3)
        h = patches @ self.conv1.kernel.to(x.dtype).reshape(p * p * 3, -1)
        c = h.shape[-1]
        cls = self.class_embedding.to(h.dtype).expand(b, 1, c)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = layer_norm(self.ln_pre, h)
        for blk in self.blocks:
            h = blk(h)
        h = layer_norm(self.ln_post, h[:, 0])
        return h @ self.proj.to(h.dtype)


class Text(nn.Module):
    def __init__(self, cfg: TextConfig, embed_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = _empty((cfg.vocab_size, cfg.width), device, torch.float32)
        self.positional_embedding = _empty((cfg.context_length, cfg.width), device, torch.float32)
        self.blocks = nn.ModuleList(
            Block(cfg.width, cfg.heads, True, device) for _ in range(cfg.layers))
        self.ln_final = Norm(cfg.width, device)
        self.text_projection = _empty((cfg.width, embed_dim), device, torch.float32)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_leaves(self, gen)
        self.token_embedding.normal_(generator=gen).mul_(0.02)
        self.positional_embedding.normal_(generator=gen).mul_(0.01)
        self.text_projection.normal_(generator=gen).mul_(self.cfg.width ** -0.5)

    def forward(self, tokens: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """tokens: [B, 77] int -> [B, embed_dim]."""
        h = self.token_embedding[tokens].to(compute_dtype)
        h = h + self.positional_embedding.to(h.dtype)
        for blk in self.blocks:
            h = blk(h)
        h = layer_norm(self.ln_final, h)
        h = h[torch.arange(h.shape[0], device=h.device), tokens.argmax(dim=-1)]
        return h @ self.text_projection.to(h.dtype)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        if not cfg.is_vit:
            raise NotImplementedError(
                f"{cfg.name}: the ModifiedResNet CLIP tower is not ported yet (ViT only)")
        self.cfg = cfg
        self.visual = ViT(cfg.vision, cfg.embed_dim, device)
        self.text = Text(cfg.text, cfg.embed_dim, device)

    def init_weights(self, gen: torch.Generator) -> "CLIP":
        self.visual.init_weights(gen)
        self.text.init_weights(gen)
        return self


def encode_image(model: CLIP, images: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """images: [B, R, R, 3], CLIP-normalized, NHWC -> [B, embed_dim] f32."""
    return model.visual(images.to(compute_dtype)).float()


def encode_text(model: CLIP, tokens: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """tokens: [B, 77] int -> [B, embed_dim] f32."""
    return model.text(tokens.long(), compute_dtype).float()
