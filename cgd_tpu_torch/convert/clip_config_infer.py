"""Infer a CLIPConfig from a torch CLIP state dict: a copy of
``cgd_tpu/convert/clip_config_infer.py``, pinned to it by
tests/test_torch_port_checkpoints.py.

The published checkpoints carry their architecture implicitly in tensor
shapes (ext clip/model.py build_model contract); this reimplements that
derivation so arbitrary local CLIP .pt checkpoints work with
``--clip_model /path/model.pt`` (reference accepts them:
cgd/script_util.py:50-53)."""

from __future__ import annotations

from cgd_tpu_torch.models.clip.configs import (
    CLIPConfig,
    TextConfig,
    VisionResNetConfig,
    VisionViTConfig,
)


def infer_clip_config(sd, name: str = "custom") -> CLIPConfig:
    embed_dim = sd["text_projection"].shape[1]
    context_length = sd["positional_embedding"].shape[0]
    vocab_size = sd["token_embedding.weight"].shape[0]
    t_width = sd["ln_final.weight"].shape[0]
    t_layers = len(
        {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}
    )
    text = TextConfig(
        context_length=context_length, vocab_size=vocab_size,
        width=t_width, heads=t_width // 64, layers=t_layers,
    )

    if "visual.proj" in sd:  # ViT
        v_width = sd["visual.conv1.weight"].shape[0]
        patch = sd["visual.conv1.weight"].shape[-1]
        v_layers = len(
            {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}
        )
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        vision = VisionViTConfig(
            input_resolution=grid * patch, patch_size=patch,
            width=v_width, layers=v_layers, heads=v_width // 64,
        )
    else:  # ModifiedResNet
        counts = []
        for li in range(1, 5):
            blocks = {k.split(".")[2] for k in sd if k.startswith(f"visual.layer{li}.")}
            counts.append(len(blocks))
        v_width = sd["visual.conv3.weight"].shape[0]  # stem output = width
        spacial = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision = VisionResNetConfig(
            input_resolution=spacial * 32, width=v_width,
            layers=tuple(counts), heads=(v_width * 32) // 64,
        )
    return CLIPConfig(name=name, embed_dim=embed_dim, vision=vision, text=text)
