"""CLIP towers (ViT, ModifiedResNet, text) as PyTorch modules, counterpart
of ``cgd_tpu/models/clip/model.py``. Module paths follow the JAX pytree
(``visual.blocks.0.attn_qkv.kernel``, ``visual.layer3.5.conv2.kernel``) so
weights carry across by name; layouts are the JAX ones (NHWC images,
``[in, out]`` dense kernels, HWIO conv kernels). LayerNorm, the folded
BatchNorm and softmax run in f32 islands inside bf16 activations. The
ModifiedResNet's convs are plain ``F.conv2d`` (the JAX package runs them as
XLA convs, outside its Pallas kernels).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cgd_tpu_torch.models.clip.configs import (
    CLIPConfig,
    TextConfig,
    VisionResNetConfig,
    VisionViTConfig,
)
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


class _ConvKernel(nn.Module):
    """A bias-free HWIO conv kernel (``cgd_tpu.ops.nn.conv_init``'s kernel)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = _empty((kh, kw, cin, cout), device, torch.float32)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        kh, kw, cin, _ = self.kernel.shape
        bound = 1.0 / math.sqrt(kh * kw * cin)
        self.kernel.uniform_(-bound, bound, generator=gen)


class ViT(nn.Module):
    def __init__(self, cfg: VisionViTConfig, embed_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        n_tok = (cfg.input_resolution // cfg.patch_size) ** 2 + 1
        self.conv1 = _ConvKernel(cfg.patch_size, cfg.patch_size, 3, cfg.width, device)
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


# ---------------------------------------------------------------------------
# ModifiedResNet visual tower
# ---------------------------------------------------------------------------

def _bn(p, x: torch.Tensor) -> torch.Tensor:
    """Folded (inference) BatchNorm: x*scale + bias in f32, cast back."""
    return (x.float() * p.scale + p.bias).to(x.dtype)


def _conv(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Bias-free NHWC conv with the HWIO kernel, symmetric k//2 padding."""
    k = p.kernel.to(x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=stride,
                   padding=(k.shape[0] // 2, k.shape[1] // 2))
    return out.permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = _ConvKernel(1, 1, cin, planes, device)
        self.bn1 = Norm(planes, device)
        self.conv2 = _ConvKernel(3, 3, planes, planes, device)
        self.bn2 = Norm(planes, device)
        self.conv3 = _ConvKernel(1, 1, planes, planes * 4, device)
        self.bn3 = Norm(planes * 4, device)
        self.down_conv = self.down_bn = None
        if stride > 1 or cin != planes * 4:
            self.down_conv = _ConvKernel(1, 1, cin, planes * 4, device)
            self.down_bn = Norm(planes * 4, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_bn(self.bn1, _conv(self.conv1, x)))
        out = F.relu(_bn(self.bn2, _conv(self.conv2, out)))
        if self.stride > 1:
            out = cnn.avg_pool_2x(out)  # anti-aliased rect-2 downsample
        out = _bn(self.bn3, _conv(self.conv3, out))
        identity = x
        if self.down_conv is not None:
            if self.stride > 1:
                identity = cnn.avg_pool_2x(identity)
            identity = _bn(self.down_bn, _conv(self.down_conv, identity))
        return F.relu(out + identity)


class AttnPool(nn.Module):
    """Attention pooling whose single query is the mean token."""

    def __init__(self, spacial: int, c: int, embed_dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.positional_embedding = _empty((spacial ** 2 + 1, c), device, torch.float32)
        self.q_proj = Dense(c, c, device=device)
        self.k_proj = Dense(c, c, device=device)
        self.v_proj = Dense(c, c, device=device)
        self.c_proj = Dense(c, embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C] -> [B, embed_dim]."""
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c)
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        t = t + self.positional_embedding.to(t.dtype)
        d = c // self.heads
        q = cnn.dense(self.q_proj, t[:, :1]).reshape(b, 1, self.heads, d).transpose(1, 2)
        k = cnn.dense(self.k_proj, t).reshape(b, -1, self.heads, d).transpose(1, 2)
        v = cnn.dense(self.v_proj, t).reshape(b, -1, self.heads, d).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(d)
        wgt = torch.softmax(logits, dim=-1).to(t.dtype)
        o = (wgt @ v).to(t.dtype).transpose(1, 2).reshape(b, c)
        return cnn.dense(self.c_proj, o)


class ModifiedResNet(nn.Module):
    """CLIP's ResNet tower (RN50 ... RN50x16): a 3-conv stem, four stages of
    bottlenecks with anti-aliased (avg-pool) strides, attention pooling."""

    def __init__(self, cfg: VisionResNetConfig, embed_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = _ConvKernel(3, 3, 3, w // 2, device)
        self.bn1 = Norm(w // 2, device)
        self.conv2 = _ConvKernel(3, 3, w // 2, w // 2, device)
        self.bn2 = Norm(w // 2, device)
        self.conv3 = _ConvKernel(3, 3, w // 2, w, device)
        self.bn3 = Norm(w, device)
        cin = w
        for i, (blocks, planes, stride) in enumerate(
                zip(cfg.layers, (w, w * 2, w * 4, w * 8), (1, 2, 2, 2))):
            layer = [Bottleneck(cin, planes, stride, device)]
            cin = planes * 4
            layer += [Bottleneck(cin, planes, 1, device) for _ in range(blocks - 1)]
            setattr(self, f"layer{i + 1}", nn.ModuleList(layer))
        self.attnpool = AttnPool(cfg.input_resolution // 32, w * 32, embed_dim, cfg.heads, device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """``_init_resnet``'s scales, in its order: conv kernels uniform in
        +-1/sqrt(fan_in), unit folded BN, the attnpool's positional embedding
        normal / sqrt(C), its projections uniform in +-1/sqrt(fan_in)."""
        for m in self.modules():
            if isinstance(m, (_ConvKernel, Norm, Dense)):
                m.init_weights(gen)
        pe = self.attnpool.positional_embedding
        pe.normal_(generator=gen).div_(pe.shape[1] ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, R, R, 3] normalized images -> [B, embed_dim]."""
        h = F.relu(_bn(self.bn1, _conv(self.conv1, x, stride=2)))
        h = F.relu(_bn(self.bn2, _conv(self.conv2, h)))
        h = F.relu(_bn(self.bn3, _conv(self.conv3, h)))
        h = cnn.avg_pool_2x(h)
        for i in range(4):
            for blk in getattr(self, f"layer{i + 1}"):
                h = blk(h)
        return self.attnpool(h)


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
        self.cfg = cfg
        if cfg.is_vit:
            self.visual = ViT(cfg.vision, cfg.embed_dim, device)
        else:
            self.visual = ModifiedResNet(cfg.vision, cfg.embed_dim, device)
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
