"""The run's inputs, made from its seed: the models' weights under their
published names (drawn on the device in one call per model, in float16, as
they are stored), the port's converted caches written from them, a
synthetic BPE merge table and, where the traffic asks for one, an init
image. The reference takes the same published weights.

Scales: matrices and conv kernels N(0, 1 / fan_in) (the published
zero-initialised output layers drawn like the others, so the model's
output is not zero); norm weights 1 + N(0, 0.05^2); biases N(0, 0.05^2);
the token embedding N(0, 0.02^2), the text positional embedding
N(0, 0.01^2); the ViT class / positional embeddings and the projections
N(0, 1 / width); the LPIPS heads |N(0, 0.1^2)|; BatchNorm running means 0
and variances 1. Vectors stay float32; tensors of two or more dimensions
are float16 (the published files are float32: ``checkpoint_dtype`` in each
configuration's ``reduced``). Then ``denoiser_path`` sets a few of the
UNet's weights so that it predicts the noise at the right scale.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Tuple

import numpy as np
import torch

from bench_h100.harness import name_map
from bench_h100.reference import png
from bench_h100.reference.adm import ADMUNet
from bench_h100.reference.bpe import bytes_to_unicode
from bench_h100.reference.clip import CLIPModel
from bench_h100.reference.lpips import LPIPSVGG

Shapes = Dict[str, Tuple[int, ...]]


def models(config: dict, with_lpips: bool):
    """The reference models on the meta device: {"unet", "clip"[, "lpips"]}."""
    with torch.device("meta"):
        out = {"unet": ADMUNet(config["unet"]), "clip": CLIPModel(config["clip"])}
        if with_lpips:
            out["lpips"] = LPIPSVGG()
    return out


def published_shapes(config: dict, with_lpips: bool) -> Dict[str, Shapes]:
    return {k: {n: tuple(t.shape) for n, t in m.state_dict().items()}
            for k, m in models(config, with_lpips).items()}


def _rule(name: str, shape) -> Tuple[float, float]:
    """(mean, std) of a parameter's draw."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_mean":
        return 0.0, 0.0
    if leaf == "running_var":
        return 1.0, 0.0
    if len(shape) == 1:
        if leaf == "weight":  # GroupNorm, LayerNorm, BatchNorm
            return 1.0, 0.05
        if leaf == "class_embedding":
            return 0.0, shape[0] ** -0.5
        return 0.0, 0.05
    if name == "token_embedding.weight":
        return 0.0, 0.02
    if name == "positional_embedding":
        return 0.0, 0.01
    if leaf in ("positional_embedding", "proj", "text_projection"):
        return 0.0, shape[-1 if leaf == "positional_embedding" else 0] ** -0.5
    if name == "label_emb.weight":
        return 0.0, 1.0
    if name.startswith("lin"):
        return 0.0, 0.1
    return 0.0, float(np.prod(shape[1:])) ** -0.5


def draw(shapes: Shapes, gen: torch.Generator) -> Dict[str, np.ndarray]:
    """One model's weights: the tensors from one float16 draw, the vectors
    from one float32 draw, scaled on the device, copied to the host once."""
    dev = gen.device
    out = {}
    for rank, dtype in ((2, torch.float16), (1, torch.float32)):
        names = [n for n, s in shapes.items() if (len(s) >= 2) == (rank == 2)]
        sizes = [int(np.prod(shapes[n])) for n in names]
        flat = torch.randn(sum(sizes), generator=gen, device=dev, dtype=dtype)
        off = 0
        for n, size in zip(names, sizes):
            mean, std = _rule(n, shapes[n])
            view = flat[off:off + size]
            view.mul_(std).add_(mean)
            if n.startswith("lin"):
                view.abs_()
            off += size
        host = flat.cpu().numpy()
        del flat
        off = 0
        for n, size in zip(names, sizes):
            out[n] = host[off:off + size].reshape(shapes[n])
            off += size
    return out


def write_cache(path: str, flat: Dict[str, np.ndarray]) -> int:
    """The port's ``.npz.cgd`` layout: a flat npz keyed by the module path
    with '/' between the parts, synced to the disk, so that its write-back
    happens in set-up and not under the window. Returns the bytes written."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **{k.replace(".", "/"): v for k, v in flat.items()})
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)


RANDOM_EPS = 1.0 / 256  # the share of the random network in the predicted noise
PATH_SCALE = 2.0 ** -13  # x on the input conv's path channels, so GroupNorm's eps dominates
GN_EPS = 1e-5  # the published GroupNorm32's


def _bf16(v: float) -> float:
    """``v`` rounded to bfloat16 (exact in float16 and float32 as well)."""
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float())


def denoiser_path(sd: Dict[str, np.ndarray]) -> None:
    """Makes the random UNet a denoiser of the right scale, in place: the
    predicted noise is ``x`` itself, to within some 0.1%, plus
    ``RANDOM_EPS`` of the random network's output, as a trained model's
    prediction is close to ``x`` at large t. Without it the denoised
    prediction, ``sqrt(1/abar) x - sqrt(1/abar - 1) eps``, lies some 150
    times outside the image's range at the first steps, the range loss
    drives ``x`` up 15-20 times a step, and every frame saturates.

    The path: the input conv copies ``PATH_SCALE x`` (channels 0-2) and
    ``-PATH_SCALE x`` (channels P to P + 2, P a whole number of GroupNorm
    groups on) at its centre tap; the last output block's 1x1 skip conv
    carries those channels of its skip input to its output, and its residual
    branch adds nothing there; the output GroupNorm's groups over them hold
    a variance far under its eps, so it scales them by a constant, the
    ``-x`` groups the mirror of the ``x`` groups; ``SiLU(z) - SiLU(-z) = z``
    at the output conv's centre tap (+a, -a) gives ``x``. The constants are
    exact in bfloat16 and float16. Every other weight keeps its draw, and the
    output conv's noise rows are scaled by ``RANDOM_EPS``.
    """
    w_in = sd["input_blocks.0.0.weight"]
    ch = w_in.shape[0]
    gs = ch // 32  # GroupNorm32's group size
    P = -(-3 // gs) * gs
    last = max(int(k.split(".")[1]) for k in sd if k.startswith("output_blocks."))
    blk = f"output_blocks.{last}"
    skip = sd[f"{blk}.0.skip_connection.weight"]
    ch_prev = skip.shape[1] - ch
    path = list(range(2 * P))
    gain = 26.0  # the GroupNorm's scale; with ``a`` below, gain a PATH_SCALE / sqrt(GN_EPS) ~ 1
    a = _bf16(GN_EPS ** 0.5 / PATH_SCALE / gain)

    w_in[path] = 0
    sd["input_blocks.0.0.bias"][path] = 0
    skip[path] = 0
    sd[f"{blk}.0.skip_connection.bias"][path] = 0
    for name in [k for k in sd if k.startswith(f"{blk}.") and k.endswith(
            (".out_layers.3.weight", ".out_layers.3.bias", ".proj_out.weight", ".proj_out.bias"))]:
        sd[name][path] = 0
    sd["out.0.weight"][path] = gain
    sd["out.0.bias"][path] = 0
    w_out, b_out = sd["out.2.weight"], sd["out.2.bias"]
    w_out[:3] *= RANDOM_EPS
    b_out[:3] *= RANDOM_EPS
    w_out[:3, path] = 0
    for c in range(3):
        w_in[c, c, 1, 1], w_in[P + c, c, 1, 1] = PATH_SCALE, -PATH_SCALE
        skip[c, ch_prev + c], skip[P + c, ch_prev + P + c] = 1, 1
        w_out[c, c, 1, 1], w_out[c, P + c, 1, 1] = a, -a


def make_weights(config: dict, seed: int, device, with_lpips: bool) -> Dict[str, dict]:
    gen = torch.Generator(device).manual_seed(seed)
    out = {k: draw(shapes, gen) for k, shapes in published_shapes(config, with_lpips).items()}
    denoiser_path(out["unet"])
    return out


def write_caches(config: dict, weights: Dict[str, dict], checkpoints_dir: str) -> int:
    """Each model's converted cache where ``weights_mode="auto"`` looks for
    it: ``<checkpoints_dir>/<published file>.npz.cgd``. Returns the bytes."""
    total = 0
    for kind, sd in weights.items():
        flat = name_map.unet(sd, config["unet"]) if kind == "unet" else name_map.CONVERT[kind](sd)
        total += write_cache(os.path.join(checkpoints_dir, config[kind]["cache"]), flat)
    return total


def write_merge_table(path: str, seed: int, words, merges: int = 48894) -> None:
    """A BPE merge table of the published format and size (a version line,
    then ``merges`` lines "a b", 49408 tokens in all): first the merges that
    build each of ``words`` from its letters, then random merges of tokens
    already made, from ``seed``. The words' merges rank first, so prompts of
    those words tokenize alike under every seed's table (a process that
    keeps the first table it loaded, as the port's tokenizer does, still
    agrees with the reference)."""
    rs = np.random.RandomState(np.random.SeedSequence([seed, 7]).generate_state(1)[0])
    symbols = list(bytes_to_unicode().values())
    made = set(symbols) | {s + "</w>" for s in symbols}
    lines, pool = [], list(symbols)

    def add(a, b):
        if a + b not in made:
            made.add(a + b)
            lines.append(f"{a} {b}")
            if not b.endswith("</w>"):
                pool.append(a + b)

    for word in sorted(set(words)):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            add(parts[0], parts[1])
            parts = [parts[0] + parts[1]] + parts[2:]
    while len(lines) < merges:  # tokens of up to 4 symbols, merged into up to 8
        short = [t for t in pool if len(t) <= 4]
        picks = rs.randint(len(short), size=(merges, 2))
        ends = rs.rand(merges) < 0.3
        for (i, j), end in zip(picks.tolist(), ends.tolist()):
            add(short[i], short[j] + ("</w>" if end else ""))
            if len(lines) == merges:
                break
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt", encoding="utf-8", compresslevel=1) as f:
        f.write("#version: 0.2\n" + "\n".join(lines[:merges]) + "\n")


def write_init_image(path: str, seed: int, size: int) -> None:
    """A smooth seeded RGB image (an 8 x 8 grid of colours, bilinearly
    upsampled, plus a little noise) as a PNG of ``size`` x ``size``."""
    rs = np.random.RandomState(np.random.SeedSequence([seed, 11]).generate_state(1)[0])
    grid = rs.rand(8, 8, 3)
    pos = np.linspace(0, 7, size)
    i0 = np.clip(np.floor(pos).astype(int), 0, 6)
    f = (pos - i0)[:, None]
    rows = grid[i0] * (1 - f)[:, :, None] + grid[i0 + 1] * f[:, :, None]  # [size, 8, 3]
    img = rows[:, i0] * (1 - f.T)[:, :, None] + rows[:, i0 + 1] * f.T[:, :, None]
    img = np.clip(img + 0.03 * rs.randn(size, size, 3), 0, 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(png.encode((img * 255 + 0.5).astype(np.uint8)))
