"""Published checkpoint names and layouts -> the port's converted-cache
keys and layouts: a frozen copy of what ``cgd_tpu_torch/convert/torch_unet.py``,
``torch_clip.py`` and ``torch_lpips.py`` do, kept here so that the
benchmark writes the caches ``weights_mode="auto"`` reads without running
the program's converters.

Layouts: conv ``[out, in, kh, kw]`` -> HWIO; linear ``[out, in]`` -> ``[in,
out]``; norms' weight / bias -> scale / bias; the ADM attention's legacy
qkv rows ``[head][q|k|v][d]`` -> ``[q|k|v][head][d]``; the ModifiedResNet's
BatchNorms folded into scale = weight / sqrt(var + 1e-5), bias = bias -
mean * scale (in float64, stored as float32).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np


def _hwio(w):
    return np.transpose(w, (2, 3, 1, 0))


def _conv(out, sd, key, name, bias=True):
    out[f"{key}.kernel"] = _hwio(sd[f"{name}.weight"])
    if bias:
        out[f"{key}.bias"] = sd[f"{name}.bias"]


def _linear(out, sd, key, name):
    out[f"{key}.kernel"] = sd[f"{name}.weight"].T
    out[f"{key}.bias"] = sd[f"{name}.bias"]


def _norm(out, sd, key, name):
    out[f"{key}.scale"] = sd[f"{name}.weight"]
    out[f"{key}.bias"] = sd[f"{name}.bias"]


def _bn_fold(out, sd, key, name, eps=1e-5):
    g, b, m, v = (np.asarray(sd[f"{name}.{s}"], np.float64)
                  for s in ("weight", "bias", "running_mean", "running_var"))
    scale = g / np.sqrt(v + eps)
    out[f"{key}.scale"] = scale.astype(np.float32)
    out[f"{key}.bias"] = (b - m * scale).astype(np.float32)


def unet(sd: Dict[str, np.ndarray], flags: dict) -> Dict[str, np.ndarray]:
    """guided-diffusion UNet state dict -> the port's UNet keys."""
    head_ch = flags.get("num_head_channels", -1)
    out: Dict[str, np.ndarray] = {}
    _linear(out, sd, "time_embed.0", "time_embed.0")
    _linear(out, sd, "time_embed.1", "time_embed.2")
    _conv(out, sd, "conv_in", "input_blocks.0.0")
    layers = sorted({m.group(1, 2, 3) for m in (re.match(r"(input_blocks|middle_block|output_blocks)"
                                                          r"\.(\d+)\.?(\d*)\.", k) for k in sd)
                     if m}, key=lambda g: (g[0], int(g[1]), int(g[2] or 0)))
    for part, i, j in layers:
        if part == "input_blocks":
            if i == "0":
                continue
            key, name = f"input.{int(i) - 1}.{j}", f"input_blocks.{i}.{j}"
        elif part == "middle_block":
            key, name = f"middle.{i}", f"middle_block.{i}"
        else:
            key, name = f"output.{i}.{j}", f"output_blocks.{i}.{j}"
        if f"{name}.in_layers.0.weight" in sd:
            _norm(out, sd, f"{key}.in_norm", f"{name}.in_layers.0")
            _conv(out, sd, f"{key}.in_conv", f"{name}.in_layers.2")
            _linear(out, sd, f"{key}.emb", f"{name}.emb_layers.1")
            _norm(out, sd, f"{key}.out_norm", f"{name}.out_layers.0")
            _conv(out, sd, f"{key}.out_conv", f"{name}.out_layers.3")
            if f"{name}.skip_connection.weight" in sd:
                _conv(out, sd, f"{key}.skip", f"{name}.skip_connection")
        elif f"{name}.qkv.weight" in sd:
            _norm(out, sd, f"{key}.norm", f"{name}.norm")
            w, b = sd[f"{name}.qkv.weight"][:, :, 0], sd[f"{name}.qkv.bias"]
            ch = w.shape[1]
            heads = ch // head_ch if head_ch != -1 else flags.get("num_heads", 1)
            d = ch // heads
            if not flags.get("use_new_attention_order", False):
                w = w.reshape(heads, 3, d, ch).transpose(1, 0, 2, 3).reshape(3 * ch, ch)
                b = b.reshape(heads, 3, d).transpose(1, 0, 2).reshape(3 * ch)
            out[f"{key}.qkv.kernel"], out[f"{key}.qkv.bias"] = w.T, b
            out[f"{key}.proj.kernel"] = sd[f"{name}.proj_out.weight"][:, :, 0].T
            out[f"{key}.proj.bias"] = sd[f"{name}.proj_out.bias"]
        elif f"{name}.op.weight" in sd:
            _conv(out, sd, f"{key}.conv", f"{name}.op")
        elif f"{name}.conv.weight" in sd:
            _conv(out, sd, f"{key}.conv", f"{name}.conv")
    _norm(out, sd, "out_norm", "out.0")
    _conv(out, sd, "out_conv", "out.2")
    if "label_emb.weight" in sd:
        out["label_emb.table"] = sd["label_emb.weight"]
    return out


def _tx_block(out, sd, key, name):
    _norm(out, sd, f"{key}.ln_1", f"{name}.ln_1")
    out[f"{key}.attn_qkv.kernel"] = sd[f"{name}.attn.in_proj_weight"].T
    out[f"{key}.attn_qkv.bias"] = sd[f"{name}.attn.in_proj_bias"]
    _linear(out, sd, f"{key}.attn_out", f"{name}.attn.out_proj")
    _norm(out, sd, f"{key}.ln_2", f"{name}.ln_2")
    _linear(out, sd, f"{key}.mlp_fc", f"{name}.mlp.c_fc")
    _linear(out, sd, f"{key}.mlp_proj", f"{name}.mlp.c_proj")


def _count(sd, prefix):
    return len({k.split(".")[len(prefix.split("."))] for k in sd if k.startswith(prefix + ".")})


def clip(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """OpenAI CLIP state dict (ViT or ModifiedResNet) -> the port's keys."""
    out: Dict[str, np.ndarray] = {}
    if "visual.proj" in sd:
        _conv(out, sd, "visual.conv1", "visual.conv1", bias=False)
        for k in ("class_embedding", "positional_embedding", "proj"):
            out[f"visual.{k}"] = sd[f"visual.{k}"]
        _norm(out, sd, "visual.ln_pre", "visual.ln_pre")
        for i in range(_count(sd, "visual.transformer.resblocks")):
            _tx_block(out, sd, f"visual.blocks.{i}", f"visual.transformer.resblocks.{i}")
        _norm(out, sd, "visual.ln_post", "visual.ln_post")
    else:
        for i in (1, 2, 3):
            _conv(out, sd, f"visual.conv{i}", f"visual.conv{i}", bias=False)
            _bn_fold(out, sd, f"visual.bn{i}", f"visual.bn{i}")
        for li in (1, 2, 3, 4):
            for bi in range(_count(sd, f"visual.layer{li}")):
                name = f"visual.layer{li}.{bi}"
                for c in (1, 2, 3):
                    _conv(out, sd, f"{name}.conv{c}", f"{name}.conv{c}", bias=False)
                    _bn_fold(out, sd, f"{name}.bn{c}", f"{name}.bn{c}")
                if f"{name}.downsample.0.weight" in sd:
                    _conv(out, sd, f"{name}.down_conv", f"{name}.downsample.0", bias=False)
                    _bn_fold(out, sd, f"{name}.down_bn", f"{name}.downsample.1")
        out["visual.attnpool.positional_embedding"] = sd["visual.attnpool.positional_embedding"]
        for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
            _linear(out, sd, f"visual.attnpool.{proj}", f"visual.attnpool.{proj}")
    out["text.token_embedding"] = sd["token_embedding.weight"]
    out["text.positional_embedding"] = sd["positional_embedding"]
    for i in range(_count(sd, "transformer.resblocks")):
        _tx_block(out, sd, f"text.blocks.{i}", f"transformer.resblocks.{i}")
    _norm(out, sd, "text.ln_final", "ln_final")
    out["text.text_projection"] = sd["text_projection"]
    return out


LPIPS_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def lpips(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torchvision VGG16 ``features.N`` and lpips ``lin{i}.model.1.weight``
    -> the port's VGGLPIPS keys."""
    out: Dict[str, np.ndarray] = {}
    for i, cid in enumerate(LPIPS_CONV_IDS):
        _conv(out, sd, f"convs.{i}", f"features.{cid}")
    for i in range(5):
        out[f"lins.{i}.kernel"] = sd[f"lin{i}.model.1.weight"][0, :, 0, 0][:, None]
    return out


CONVERT = {"unet": unet, "clip": clip, "lpips": lpips}
