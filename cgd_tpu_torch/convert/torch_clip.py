"""CLIP checkpoint converter: the OpenAI ``.pt`` (TorchScript archive or plain
state dict) -> the port's parameters, counterpart of
``cgd_tpu/convert/torch_clip.py``. Returns a flat {dotted module path:
array} dict of ``cgd_tpu_torch.models.clip.model.CLIP``. The ModifiedResNet
tower's BatchNorms are folded into inference scale / bias here (the tower
keeps no running statistics).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cgd_tpu_torch.models.clip.configs import CLIPConfig, VisionResNetConfig


def _f32(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def _t(w) -> np.ndarray:
    return np.transpose(_f32(w), (1, 0))


def _linear(out, sd, key, name):
    out[f"{key}.kernel"] = _t(sd[f"{name}.weight"])
    out[f"{key}.bias"] = _f32(sd[f"{name}.bias"])


def _ln(out, sd, key, name):
    out[f"{key}.scale"] = _f32(sd[f"{name}.weight"])
    out[f"{key}.bias"] = _f32(sd[f"{name}.bias"])


def _conv_hwio(out, sd, key, name):
    out[f"{key}.kernel"] = np.transpose(_f32(sd[f"{name}.weight"]), (2, 3, 1, 0))


def _bn_fold(out, sd, key, name, eps=1e-5):
    gamma = _f32(sd[f"{name}.weight"])
    beta = _f32(sd[f"{name}.bias"])
    mean = _f32(sd[f"{name}.running_mean"])
    var = _f32(sd[f"{name}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    out[f"{key}.scale"] = scale
    out[f"{key}.bias"] = beta - mean * scale


def _tx_block(out, sd, key, name):
    _ln(out, sd, f"{key}.ln_1", f"{name}.ln_1")
    out[f"{key}.attn_qkv.kernel"] = _t(sd[f"{name}.attn.in_proj_weight"])
    out[f"{key}.attn_qkv.bias"] = _f32(sd[f"{name}.attn.in_proj_bias"])
    _linear(out, sd, f"{key}.attn_out", f"{name}.attn.out_proj")
    _ln(out, sd, f"{key}.ln_2", f"{name}.ln_2")
    _linear(out, sd, f"{key}.mlp_fc", f"{name}.mlp.c_fc")
    _linear(out, sd, f"{key}.mlp_proj", f"{name}.mlp.c_proj")


def _vit_visual(out, sd, n_layers: int):
    _conv_hwio(out, sd, "visual.conv1", "visual.conv1")
    out["visual.class_embedding"] = _f32(sd["visual.class_embedding"])
    out["visual.positional_embedding"] = _f32(sd["visual.positional_embedding"])
    _ln(out, sd, "visual.ln_pre", "visual.ln_pre")
    for i in range(n_layers):
        _tx_block(out, sd, f"visual.blocks.{i}", f"visual.transformer.resblocks.{i}")
    _ln(out, sd, "visual.ln_post", "visual.ln_post")
    out["visual.proj"] = _f32(sd["visual.proj"])


def _rn_visual(out, sd, cfg: VisionResNetConfig):
    for i in (1, 2, 3):
        _conv_hwio(out, sd, f"visual.conv{i}", f"visual.conv{i}")
        _bn_fold(out, sd, f"visual.bn{i}", f"visual.bn{i}")
    for li, n in enumerate(cfg.layers):
        for bi in range(n):
            key = name = f"visual.layer{li + 1}.{bi}"
            for c in (1, 2, 3):
                _conv_hwio(out, sd, f"{key}.conv{c}", f"{name}.conv{c}")
                _bn_fold(out, sd, f"{key}.bn{c}", f"{name}.bn{c}")
            if f"{name}.downsample.0.weight" in sd:
                _conv_hwio(out, sd, f"{key}.down_conv", f"{name}.downsample.0")
                _bn_fold(out, sd, f"{key}.down_bn", f"{name}.downsample.1")
    out["visual.attnpool.positional_embedding"] = _f32(sd["visual.attnpool.positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(out, sd, f"visual.attnpool.{proj}", f"visual.attnpool.{proj}")


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """A reference-layout CLIP state dict (numpy values) -> the port's flat
    parameter dict."""
    out: Dict[str, np.ndarray] = {}
    if cfg.is_vit:
        _vit_visual(out, sd, cfg.vision.layers)
    else:
        _rn_visual(out, sd, cfg.vision)
    out["text.token_embedding"] = _f32(sd["token_embedding.weight"])
    out["text.positional_embedding"] = _f32(sd["positional_embedding"])
    for i in range(cfg.text.layers):
        _tx_block(out, sd, f"text.blocks.{i}", f"transformer.resblocks.{i}")
    _ln(out, sd, "text.ln_final", "ln_final")
    out["text.text_projection"] = _f32(sd["text_projection"])
    return out


def load_torch_clip_sd(pt_path: str) -> Dict[str, np.ndarray]:
    """A CLIP checkpoint (TorchScript archive or plain state dict) as a numpy
    state dict, half-precision weights widened to f32."""
    import torch

    try:
        model = torch.jit.load(pt_path, map_location="cpu")
        sd = model.state_dict()
    except RuntimeError:
        sd = torch.load(pt_path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: (v.float().numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}


def convert_clip_checkpoint(pt_path: str, cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    return convert_state_dict(load_torch_clip_sd(pt_path), cfg)
