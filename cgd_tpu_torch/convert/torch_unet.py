"""ADM UNet checkpoint converter: the published guided-diffusion state dict
-> the port's parameters, counterpart of ``cgd_tpu/convert/torch_unet.py``.

Maps the checkpoint naming (time_embed.N / input_blocks.N.M / middle_block.M
/ output_blocks.N.M / out.N) onto the block plan of
``cgd_tpu_torch.models.unet``, and returns a flat {dotted module path:
array} dict, the JAX converter's tree flattened
(``cgd_tpu_torch.convert.from_jax.load_flat`` loads it). Layouts:

- conv OIHW -> HWIO; linear [out, in] -> [in, out]; GroupNorm weight / bias
  -> scale / bias;
- attention qkv: a 1x1 conv1d [3C, C, 1]. The legacy order interleaves per
  head ([h][q|k|v][d]); the new order (use_new_attention_order) chunks
  q|k|v first ([q|k|v][h][d]), the port's dense layout, so legacy weights
  are permuted here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cgd_tpu_torch.models.unet import UNetConfig, block_plan


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _conv(out, sd, key, name):
    out[f"{key}.kernel"] = np.transpose(_f32(sd[f"{name}.weight"]), (2, 3, 1, 0))
    out[f"{key}.bias"] = _f32(sd[f"{name}.bias"])


def _linear(out, sd, key, name):
    out[f"{key}.kernel"] = np.transpose(_f32(sd[f"{name}.weight"]), (1, 0))
    out[f"{key}.bias"] = _f32(sd[f"{name}.bias"])


def _norm(out, sd, key, name):
    out[f"{key}.scale"] = _f32(sd[f"{name}.weight"])
    out[f"{key}.bias"] = _f32(sd[f"{name}.bias"])


def _qkv(out, sd, key, name, ch: int, num_heads: int, new_order: bool):
    """1x1 conv1d qkv -> dense kernel [C, 3C] in the [q|k|v][h][d] order."""
    w = _f32(sd[f"{name}.weight"])[:, :, 0]  # [3C, C]
    b = _f32(sd[f"{name}.bias"])  # [3C]
    d = ch // num_heads
    if not new_order:  # legacy rows [h][qkv][d] -> [qkv][h][d]
        w = w.reshape(num_heads, 3, d, ch).transpose(1, 0, 2, 3).reshape(3 * ch, ch)
        b = b.reshape(num_heads, 3, d).transpose(1, 0, 2).reshape(3 * ch)
    out[f"{key}.kernel"] = np.transpose(w, (1, 0))
    out[f"{key}.bias"] = b


def _proj1d(out, sd, key, name):
    out[f"{key}.kernel"] = np.transpose(_f32(sd[f"{name}.weight"])[:, :, 0], (1, 0))
    out[f"{key}.bias"] = _f32(sd[f"{name}.bias"])


def _layer(out, sd, key, name, spec, cfg: UNetConfig):
    kind = spec[0]
    if kind == "res":
        _norm(out, sd, f"{key}.in_norm", f"{name}.in_layers.0")
        _conv(out, sd, f"{key}.in_conv", f"{name}.in_layers.2")
        _linear(out, sd, f"{key}.emb", f"{name}.emb_layers.1")
        _norm(out, sd, f"{key}.out_norm", f"{name}.out_layers.0")
        _conv(out, sd, f"{key}.out_conv", f"{name}.out_layers.3")
        if f"{name}.skip_connection.weight" in sd:
            _conv(out, sd, f"{key}.skip", f"{name}.skip_connection")
    elif kind == "attn":
        ch = spec[1]
        _norm(out, sd, f"{key}.norm", f"{name}.norm")
        _qkv(out, sd, f"{key}.qkv", f"{name}.qkv", ch, cfg.heads_for(ch),
             cfg.use_new_attention_order)
        _proj1d(out, sd, f"{key}.proj", f"{name}.proj_out")
    elif kind == "downsample":
        _conv(out, sd, f"{key}.conv", f"{name}.op")
    elif kind == "upsample":
        _conv(out, sd, f"{key}.conv", f"{name}.conv")
    else:
        raise ValueError(kind)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: UNetConfig) -> Dict[str, np.ndarray]:
    """A reference-layout UNet state dict (numpy values) -> the port's flat
    parameter dict."""
    input_plan, middle_plan, output_plan, _ = block_plan(cfg)
    out: Dict[str, np.ndarray] = {}
    _linear(out, sd, "time_embed.0", "time_embed.0")
    _linear(out, sd, "time_embed.1", "time_embed.2")
    _conv(out, sd, "conv_in", "input_blocks.0.0")
    for i, blk in enumerate(input_plan):
        for j, spec in enumerate(blk):
            _layer(out, sd, f"input.{i}.{j}", f"input_blocks.{i + 1}.{j}", spec, cfg)
    for j, spec in enumerate(middle_plan):
        _layer(out, sd, f"middle.{j}", f"middle_block.{j}", spec, cfg)
    for i, blk in enumerate(output_plan):
        for j, spec in enumerate(blk):
            _layer(out, sd, f"output.{i}.{j}", f"output_blocks.{i}.{j}", spec, cfg)
    _norm(out, sd, "out_norm", "out.0")
    _conv(out, sd, "out_conv", "out.2")
    if cfg.num_classes is not None:
        out["label_emb.table"] = _f32(sd["label_emb.weight"])
    return out


def convert_unet_checkpoint(pt_path: str, cfg: UNetConfig) -> Dict[str, np.ndarray]:
    import torch

    sd = torch.load(pt_path, map_location="cpu")
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    return convert_state_dict(sd, cfg)
