"""Zero-shot ImageNet class ranking, counterpart of ``cgd_tpu/zero_shot.py``
(the reference's ``imagenet_top_n``, cgd/clip_util.py:72-87: defined and
tested upstream though the sampling path does not use it).

The class names are public ImageNet-1k metadata, a copy of the JAX
package's ``data_imagenet_classes.json`` kept beside this module (pinned
equal to it by tests/test_torch_port_zero_shot.py)."""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np
import torch

from cgd_tpu_torch.models.clip.model import encode_text


@lru_cache(maxsize=1)
def imagenet_classes():
    path = os.path.join(os.path.dirname(__file__), "data_imagenet_classes.json")
    with open(path) as f:
        return json.load(f)


@torch.no_grad()
def imagenet_top_n(text_encodes, clip_model, clip_cfg, tokenizer, n: int = None) -> np.ndarray:
    """Rank ImageNet classes by CLIP similarity to ``text_encodes`` [B, D].

    Returns the top-n class indices of the first row (all 1000 by default),
    with the reference's prompt engineering ("an image of a {cls}") and
    softmax(100 * cos) scoring. The text tower runs on the model's device in
    chunks of 250 prompts."""
    classes = imagenet_classes()
    if n is None:
        n = len(classes)
    prompts = [f"an image of a {c}" for c in classes]
    tokens = tokenizer.tokenize(prompts, context_length=clip_cfg.text.context_length,
                                truncate=True)
    device = next(clip_model.parameters()).device
    feats = []
    for i in range(0, len(prompts), 250):  # chunk to bound memory
        chunk = torch.as_tensor(np.asarray(tokens[i:i + 250]), device=device)
        feats.append(encode_text(clip_model, chunk).cpu().numpy())
    feats = np.concatenate(feats, 0)
    feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)

    q = np.asarray(text_encodes, dtype=np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    logits = torch.from_numpy(100.0 * q @ feats.T)
    probs = torch.softmax(logits, dim=-1).numpy()
    order = np.argsort(-probs, axis=-1)
    return order[0][:n]
