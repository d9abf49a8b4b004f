"""ADM UNet as PyTorch modules, counterpart of ``cgd_tpu/models/unet.py``.

The module tree follows the JAX parameter pytree, so every parameter's
``state_dict`` key is its JAX path joined with dots
(``input.0.0.in_conv.kernel``) and carrying weights across is a flatten with
no transposes (``cgd_tpu_torch.convert.from_jax``). Layouts are the JAX ones:
NHWC activations, HWIO conv kernels, ``[in, out]`` dense kernels.

    cfg = UNetConfig.from_flags(flags)
    unet = UNet(cfg, device="cuda")
    unet.init_weights(torch.Generator("cuda").manual_seed(0))
    out = unet(x_nhwc, timesteps, y, compute_dtype=torch.bfloat16)

The same forward runs on a height-split activation
(``cgd_tpu_torch.parallel.mesh.Split``, the JAX package's
``spatial_sharding``): the ops take it shard by shard, the attention blocks
gather each data group whole and split it back, a level whose height the
'cut' axis does not divide runs whole (``parallel/mesh.py``), and the
embedding path stays unsplit.

Under the guidance gradient the forward can be rematerialized, as the JAX
package's ``apply_unet(remat_min_dim=...)`` and ``jax.checkpoint`` do:
``UNet.forward(remat_min_dim=N)`` runs every layer whose input is at least
N rows high under ``torch.utils.checkpoint`` (its internals recomputed in
the backward), and ``rematerialized(fn)`` wraps a whole forward
(``api._resolve_remat`` decides when).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cgd_tpu_torch.ops import nn as cnn
from cgd_tpu_torch.parallel.mesh import Split

DEFAULT_CHANNEL_MULT: Dict[int, Tuple[float, ...]] = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 2, 2),
}


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int
    in_channels: int = 3
    model_channels: int = 256
    out_channels: int = 6
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (4, 8, 16)  # downsample factors with attention
    dropout: float = 0.0
    channel_mult: Tuple[float, ...] = (1, 1, 2, 2, 4, 4)
    num_classes: Optional[int] = None
    num_heads: int = 1
    num_head_channels: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    use_new_attention_order: bool = False  # conversion-time concern only

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    def heads_for(self, ch: int) -> int:
        if self.num_head_channels != -1:
            if ch % self.num_head_channels:
                raise ValueError(f"{ch} channels not divisible by {self.num_head_channels}")
            return ch // self.num_head_channels
        return self.num_heads

    @staticmethod
    def from_flags(flags: dict) -> "UNetConfig":
        """Build from a reference-style flag dict (``cgd_tpu_torch.registry``)."""
        image_size = flags["image_size"]
        attn = flags.get("attention_resolutions", "32,16,8")
        if isinstance(attn, str):
            attn_res = [int(r.strip()) for r in attn.split(",") if r.strip()]
        else:
            attn_res = list(attn)
        channel_mult = flags.get("channel_mult") or DEFAULT_CHANNEL_MULT[image_size]
        return UNetConfig(
            image_size=image_size,
            model_channels=flags.get("num_channels", 256),
            out_channels=6 if flags.get("learn_sigma", True) else 3,
            num_res_blocks=flags.get("num_res_blocks", 2),
            attention_ds=tuple(image_size // r for r in attn_res),
            dropout=flags.get("dropout", 0.0),
            channel_mult=tuple(channel_mult),
            num_classes=(1000 if flags.get("class_cond") else None),
            num_heads=flags.get("num_heads", 1),
            num_head_channels=flags.get("num_head_channels", -1),
            use_scale_shift_norm=flags.get("use_scale_shift_norm", True),
            resblock_updown=flags.get("resblock_updown", True),
            use_new_attention_order=flags.get("use_new_attention_order", False),
        )


def block_plan(cfg: UNetConfig):
    """Static network description shared by construction and forward, the
    same plan as ``cgd_tpu.models.unet.block_plan``. Entries:
    ("res", cin, cout, mode) with mode in {"", "up", "down"}, ("attn", ch),
    ("downsample", ch) / ("upsample", ch)."""
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    input_plan: List[List[tuple]] = []
    input_chs = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [("res", ch, int(mult * mc), "")]
            ch = int(mult * mc)
            if ds in cfg.attention_ds:
                layers.append(("attn", ch))
            input_plan.append(layers)
            input_chs.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                input_plan.append([("res", ch, ch, "down")])
            else:
                input_plan.append([("downsample", ch)])
            input_chs.append(ch)
            ds *= 2

    middle_plan = [("res", ch, ch, ""), ("attn", ch), ("res", ch, ch, "")]

    output_plan: List[List[tuple]] = []
    chs = list(input_chs)
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chs.pop()
            layers = [("res", ch + ich, int(mult * mc), "")]
            ch = int(mult * mc)
            if ds in cfg.attention_ds:
                layers.append(("attn", ch))
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    layers.append(("res", ch, ch, "up"))
                else:
                    layers.append(("upsample", ch))
                ds //= 2
            output_plan.append(layers)
    return input_plan, middle_plan, output_plan, ch


# ---------------------------------------------------------------------------
# parameter leaves (attribute names are the JAX leaf names)
# ---------------------------------------------------------------------------

def _empty(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Conv(nn.Module):
    """HWIO conv kernel + bias (``cgd_tpu.ops.nn.conv_init``)."""

    def __init__(self, kh, kw, cin, cout, zero=False, device=None, dtype=torch.float32):
        super().__init__()
        self.zero = zero
        self.kernel = _empty((kh, kw, cin, cout), device, dtype)
        self.bias = _empty((cout,), device, dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        kh, kw, cin, _ = self.kernel.shape
        if self.zero:
            self.kernel.zero_()
        else:
            bound = 1.0 / math.sqrt(kh * kw * cin)
            self.kernel.uniform_(-bound, bound, generator=gen)
        self.bias.zero_()


class Dense(nn.Module):
    """[in, out] kernel + bias (``cgd_tpu.ops.nn.dense_init``)."""

    def __init__(self, cin, cout, zero=False, device=None, dtype=torch.float32):
        super().__init__()
        self.zero = zero
        self.kernel = _empty((cin, cout), device, dtype)
        self.bias = _empty((cout,), device, dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        if self.zero:
            self.kernel.zero_()
        else:
            bound = 1.0 / math.sqrt(self.kernel.shape[0])
            self.kernel.uniform_(-bound, bound, generator=gen)
        self.bias.zero_()


class Norm(nn.Module):
    """GroupNorm / LayerNorm scale + bias."""

    def __init__(self, ch, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = _empty((ch,), device, dtype)
        self.bias = _empty((ch,), device, dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        self.scale.fill_(1.0)
        self.bias.zero_()


class Embedding(nn.Module):
    def __init__(self, num, dim, device=None, dtype=torch.float32):
        super().__init__()
        self.table = _empty((num, dim), device, dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        self.table.normal_(generator=gen)


def init_leaves(module: nn.Module, gen: torch.Generator) -> None:
    """Random init of every parameter leaf, in module order."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense, Norm, Embedding)):
            m.init_weights(gen)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, cin: int, cout: int, mode: str, device=None):
        super().__init__()
        self.mode = mode
        self.use_scale_shift_norm = cfg.use_scale_shift_norm
        emb_out = 2 * cout if cfg.use_scale_shift_norm else cout
        self.in_norm = Norm(cin, device)
        self.in_conv = Conv(3, 3, cin, cout, device=device)
        self.emb = Dense(cfg.time_embed_dim, emb_out, device=device)
        self.out_norm = Norm(cout, device)
        self.out_conv = Conv(3, 3, cout, cout, zero=True, device=device)
        self.skip = Conv(1, 1, cin, cout, device=device) if cin != cout else None

    def forward(self, x, emb):
        # GN+SiLU (+ the up/down resample) fused into the conv's load on the
        # kernel route; the exact unfused chain under kernel_routing("plain")
        h = cnn.fused_gn_silu_conv(self.in_norm, self.in_conv, x, resample=self.mode)
        if self.mode == "up":
            x = cnn.upsample_nearest_2x(x)
        elif self.mode == "down":
            x = cnn.avg_pool_2x(x)
        emb_out = cnn.dense(self.emb, cnn.silu(emb))[:, None, None, :]
        skip = cnn.conv2d(self.skip, x) if self.skip is not None else x
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            return cnn.fused_gn_silu_conv(
                self.out_norm, self.out_conv, h, scale_shift=(scale, shift), skip=skip
            )
        return cnn.fused_gn_silu_conv(self.out_norm, self.out_conv, h + emb_out, skip=skip)


class AttentionBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, ch: int, device=None):
        super().__init__()
        self.heads = cfg.heads_for(ch)
        self.norm = Norm(ch, device)
        self.qkv = Dense(ch, 3 * ch, device=device)
        self.proj = Dense(ch, ch, zero=True, device=device)

    def forward(self, x, emb=None):
        if isinstance(x, Split):  # the all-gather: attention sees the whole image
            return x.gathered(self.forward)
        b, hh, ww, c = x.shape
        flat = x.reshape(b, hh * ww, c)
        h = cnn.group_norm(self.norm, flat)
        a = cnn.qkv_attention(cnn.dense(self.qkv, h), self.heads)
        a = cnn.dense(self.proj, a)
        return (flat + a).reshape(b, hh, ww, c)


class _ConvLayer(nn.Module):
    """'downsample' / 'upsample' entries (resblock_updown=False configs)."""

    def __init__(self, ch: int, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.conv = Conv(3, 3, ch, ch, device=device)

    def forward(self, x, emb=None):
        if self.kind == "downsample":
            return cnn.conv2d(self.conv, x, stride=2)
        return cnn.conv2d(self.conv, cnn.upsample_nearest_2x(x))


def rematerialized(fn):
    """``fn`` under non-reentrant ``torch.utils.checkpoint``: the forward
    keeps none of ``fn``'s saved tensors (the custom Functions of
    ``kernels/`` save theirs through ``ctx.save_for_backward``, so the
    checkpoint's hooks catch every one) and the backward runs ``fn`` again
    to rebuild them, launching the same kernels. Non-reentrant, because the
    guided step differentiates with ``torch.autograd.grad``, and because it
    passes non-tensor arguments such as a ``Split`` through. No random state
    is saved or restored: nothing in a UNet forward draws from a generator
    (dropout is never applied in sampling; the step's ``torch.Generator`` is
    drawn outside the model)."""

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)

    return run


def _make_layer(cfg: UNetConfig, spec: tuple, device) -> nn.Module:
    kind = spec[0]
    if kind == "res":
        return ResBlock(cfg, spec[1], spec[2], spec[3], device)
    if kind == "attn":
        return AttentionBlock(cfg, spec[1], device)
    if kind in ("downsample", "upsample"):
        return _ConvLayer(spec[1], kind, device)
    raise ValueError(kind)


class UNet(nn.Module):
    """Parameters are created uninitialised (any device, including "meta");
    call ``init_weights`` for the random init or load a state dict. Dropout
    is never applied: sampling runs the model without it, as cgd_tpu's
    ``apply_unet`` does when given no rng."""

    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        input_plan, middle_plan, output_plan, out_ch = block_plan(cfg)
        ch0 = int(cfg.channel_mult[0] * cfg.model_channels)
        self.time_embed = nn.ModuleList([
            Dense(cfg.model_channels, cfg.time_embed_dim, device=device),
            Dense(cfg.time_embed_dim, cfg.time_embed_dim, device=device),
        ])
        self.conv_in = Conv(3, 3, cfg.in_channels, ch0, device=device)
        self.input = nn.ModuleList(
            nn.ModuleList(_make_layer(cfg, s, device) for s in blk) for blk in input_plan
        )
        self.middle = nn.ModuleList(_make_layer(cfg, s, device) for s in middle_plan)
        self.output = nn.ModuleList(
            nn.ModuleList(_make_layer(cfg, s, device) for s in blk) for blk in output_plan
        )
        self.out_norm = Norm(out_ch, device)
        self.out_conv = Conv(3, 3, out_ch, cfg.out_channels, zero=True, device=device)
        self.label_emb = (
            Embedding(cfg.num_classes, cfg.time_embed_dim, device)
            if cfg.num_classes is not None else None
        )

    def init_weights(self, gen: torch.Generator) -> "UNet":
        init_leaves(self, gen)
        return self

    def forward(self, x, timesteps, y=None, *, compute_dtype=torch.float32,
                remat_min_dim: Optional[int] = None):
        """x: [B,H,W,in_channels]; timesteps: [B] (float ok); y: [B] int class
        labels when class-conditional. Returns [B,H,W,out_channels] f32, split
        as x when x is a ``Split``.

        ``remat_min_dim``: partial rematerialization under a gradient, the
        JAX package's argument of that name. Each input / middle / output
        layer whose input is at least this many rows high (the whole
        activation's height, for a ``Split`` too) runs under
        ``rematerialized``: only its input is kept for the backward. None
        keeps everything."""
        cfg = self.cfg
        emb = cnn.timestep_embedding(timesteps, cfg.model_channels)
        emb = cnn.dense(self.time_embed[0], emb)
        emb = cnn.dense(self.time_embed[1], cnn.silu(emb))
        if self.label_emb is not None:
            if y is None:
                raise ValueError("class-conditional model requires y")
            emb = emb + self.label_emb.table[y]
        emb = emb.to(compute_dtype)

        def run(layer, h):
            if remat_min_dim is not None and h.shape[1] >= remat_min_dim:
                return rematerialized(layer)(h, emb)
            return layer(h, emb)

        h = cnn.conv2d(self.conv_in, x.to(compute_dtype))
        hs = [h]
        for blk in self.input:
            for layer in blk:
                h = run(layer, h)
            hs.append(h)
        for layer in self.middle:
            h = run(layer, h)
        for blk in self.output:
            h = cnn.cat_channels(h, hs.pop())
            for layer in blk:
                h = run(layer, h)
        h = cnn.fused_gn_silu_conv(self.out_norm, self.out_conv, h)
        return h.float()
