"""CLIP model configuration registry — a copy of
``cgd_tpu/models/clip/configs.py`` (pure Python), pinned to the original by
tests/test_torch_port_clip.py.

The torch checkpoints carry their architecture implicitly in state-dict
shapes (ext clip/model.py build_model contract, SURVEY.md §2b); we register
the derived hyperparameters explicitly for the 8 OpenAI releases the
reference supports (reference name table: cgd/clip_util.py:17-29).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union


@dataclasses.dataclass(frozen=True)
class VisionViTConfig:
    input_resolution: int
    patch_size: int
    width: int
    layers: int
    heads: int


@dataclasses.dataclass(frozen=True)
class VisionResNetConfig:
    input_resolution: int
    width: int  # stem width (conv3 output = width)
    layers: Tuple[int, int, int, int]
    heads: int  # attnpool heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    vision: Union[VisionViTConfig, VisionResNetConfig]
    text: TextConfig

    @property
    def input_resolution(self) -> int:
        return self.vision.input_resolution

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision, VisionViTConfig)


def _vit(name, embed, res, patch, width, layers, twidth, tlayers=12):
    return CLIPConfig(
        name=name,
        embed_dim=embed,
        vision=VisionViTConfig(res, patch, width, layers, width // 64),
        text=TextConfig(width=twidth, heads=twidth // 64, layers=tlayers),
    )


def _rn(name, embed, res, width, layers, twidth, tlayers=12):
    return CLIPConfig(
        name=name,
        embed_dim=embed,
        vision=VisionResNetConfig(res, width, layers, heads=(width * 32) // 64),
        text=TextConfig(width=twidth, heads=twidth // 64, layers=tlayers),
    )


CLIP_CONFIGS = {
    "RN50": _rn("RN50", 1024, 224, 64, (3, 4, 6, 3), 512),
    "RN101": _rn("RN101", 512, 224, 64, (3, 4, 23, 3), 512),
    "RN50x4": _rn("RN50x4", 640, 288, 80, (4, 6, 10, 6), 640),
    "RN50x16": _rn("RN50x16", 768, 384, 96, (6, 8, 18, 8), 768),
    "ViT-B/32": _vit("ViT-B/32", 512, 224, 32, 768, 12, 512),
    "ViT-B/16": _vit("ViT-B/16", 512, 224, 16, 768, 12, 512),
    "ViT-L/14": _vit("ViT-L/14", 768, 224, 14, 1024, 24, 768),
    "ViT-L/14@336px": _vit("ViT-L/14@336px", 768, 336, 14, 1024, 24, 768),
}

# CLIP image normalization constants (reference: cgd/clip_util.py:45)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
