"""CLIP score of images against a prompt: BASELINE.md's quality metric,
"CLIP-score parity with the PyTorch reference". Counterpart of the JAX
package's ``tools/clip_score.py``, with the same protocol and output.

    python -m cgd_tpu_torch.tools.clip_score --prompt "..." ref_out/*.png   # the reference's images
    python -m cgd_tpu_torch.tools.clip_score --prompt "..." our_out/*.png   # ours
    python -m cgd_tpu_torch.tools.clip_score --prompt x --weights-mode random --device cpu a.png

The score is 100 x the cosine of the image and text embeddings of the CLIP
model ``--clip`` (the published weights under ``--weights-mode auto``,
converted on first use; random ones under ``random``). Each image is
decoded without Pillow where it can be (8-bit PNGs,
``io_utils/images.decode_image``), cut to its centre square, resized to
the tower's resolution with Pillow's bicubic filter
(``resize_like_pillow``; crop first, then resize, as the JAX tool does) and
normalised with CLIP's mean and std. The prompt is tokenized by the BPE
tokenizer, or under ``random`` by the API's hash tokenizer. Everything runs
in f32 with TF32 off, on ``--device`` (cuda by default; it raises without a
card). Prints one line per image on stderr, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

import numpy as np
import torch

from cgd_tpu_torch.api import _FallbackTokenizer, _TF32Off, resolve_device
from cgd_tpu_torch.io_utils.download import CACHE_PATH
from cgd_tpu_torch.io_utils.images import decode_image, resize_like_pillow
from cgd_tpu_torch.models.clip.configs import CLIP_MEAN, CLIP_STD
from cgd_tpu_torch.models.clip.model import encode_image, encode_text
from cgd_tpu_torch.weights import resolve_clip


def prepare(rgb: np.ndarray, res: int) -> np.ndarray:
    """uint8 [H, W, 3] -> the tower's f32 input [res, res, 3]: the centre
    square, Pillow's bicubic resize, CLIP's normalisation."""
    h, w = rgb.shape[:2]
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    sq = resize_like_pillow(rgb[top:top + side, left:left + side], (res, res))
    arr = np.asarray(sq, np.float32) / 255.0
    return (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def tokenize(prompt: str, clip_cfg, weights_mode: str) -> np.ndarray:
    if weights_mode == "random":
        return _FallbackTokenizer(clip_cfg.text.vocab_size).tokenize([prompt])
    from cgd_tpu_torch.models.clip.tokenizer import get_tokenizer

    return get_tokenizer().tokenize([prompt], clip_cfg.text.context_length, truncate=True)


def scores(model, tokens: np.ndarray, images: np.ndarray) -> np.ndarray:
    """100 x cos(image embedding, text embedding) for ``images`` [N, res,
    res, 3] (``prepare``'s output) against one prompt's ``tokens``, in f32
    with TF32 off, on the model's device."""
    dev = next(model.parameters()).device
    off = _TF32Off()
    off.enter()
    try:
        with torch.no_grad():
            t = encode_text(model, torch.from_numpy(np.asarray(tokens)).to(dev))
            i = encode_image(model, torch.from_numpy(np.asarray(images)).to(dev))
    finally:
        off.exit()
    t = t / t.norm(dim=-1, keepdim=True)
    i = i / i.norm(dim=-1, keepdim=True)
    return (100.0 * (i @ t.T)[:, 0]).cpu().numpy()


def clip_score(paths: Sequence[str], prompt: str, clip: str = "ViT-B/32",
               weights_mode: str = "auto", device="cuda",
               checkpoints_dir: str = CACHE_PATH) -> dict:
    """Score ``paths`` against ``prompt``: the JSON record (prompt,
    clip_model, n, mean_clip_score, std) and ``scores``, one per path."""
    dev = resolve_device(device)
    model, cfg = resolve_clip(clip, weights_mode, dev, checkpoints_dir)
    batch = np.stack([prepare(decode_image(p), cfg.input_resolution) for p in paths])
    s = scores(model, tokenize(prompt, cfg, weights_mode), batch)
    return {"prompt": prompt, "clip_model": clip, "n": len(s),
            "mean_clip_score": float(np.mean(s)), "std": float(np.std(s)),
            "scores": [float(v) for v in s]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("images", nargs="+", help="image files to score")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--clip", default="ViT-B/32")
    ap.add_argument("--weights-mode", default="auto", choices=["auto", "random"])
    ap.add_argument("--checkpoints-dir", default=CACHE_PATH)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rec = clip_score(args.images, args.prompt, args.clip, args.weights_mode, args.device,
                     args.checkpoints_dir)
    for path, s in zip(args.images, rec.pop("scores")):
        print(f"{s:7.3f}  {path}", file=sys.stderr)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
