"""Weight resolution for the port, counterpart of ``cgd_tpu/weights.py``:
converted cache -> torch convert -> download, or random weights.

``mode="auto"`` reads the published checkpoints in the reference's cache
layout (``checkpoints_dir``, by default ~/.cache/clip-guided-diffusion, CLIP
under ``clip/``) as the original torch ``.pt`` files, and stores a converted
flat npz next to each on first use (``<name>.pt`` -> ``<name>.pt.npz.cgd``),
the JAX package's cache format (``utils/pytree_io.py``): a cache written by
either package loads in the other. A missing ``.pt`` is downloaded. The
weights are built on the host and moved to the run's device once per process
and key: the model cache below keeps one model a role (UNet, CLIP, LPIPS) on
its device, keyed by its files' identity, configuration, device and conv
dtype, and hands it to every later resolve with that key. A CLIP
model name ending in ``.pt`` / ``.pth`` is a local checkpoint whose
configuration is read from its shapes (``convert/clip_config_infer.py``),
in either mode, as in the JAX package.

``mode="random"`` gives randomly initialised weights from a fixed seed, for
runs without checkpoints; there ``CGD_TPU_DEBUG_TINY=1`` swaps in the JAX
package's toy-size UNet and CLIP (every CLIP tower, ModifiedResNet
included, becomes a tiny ViT), for CPU smoke runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cgd_tpu_torch.convert.from_jax import load_flat
from cgd_tpu_torch.io_utils.download import CACHE_PATH, download
from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS, CLIPConfig, TextConfig, VisionViTConfig
from cgd_tpu_torch.models.clip.model import CLIP
from cgd_tpu_torch.models.unet import UNet, UNetConfig
from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS
from cgd_tpu_torch.ops.nn import cast_conv_params
from cgd_tpu_torch.registry import CLIP_MODEL_URLS, DIFFUSION_LOOKUP
from cgd_tpu_torch.utils import pytree_io, tracing

_WEIGHTS_SEED = 0  # random weights are fixed, as cgd_tpu's PRNGKey(0) init


def _converted_path(pt_path: str) -> str:
    return pt_path + ".npz.cgd"


def _cached(npz_path: str, convert, model: str) -> Dict[str, np.ndarray]:
    """The flat parameters from the converted cache, or ``convert()``'s,
    written to the cache first."""
    if os.path.exists(npz_path):
        with tracing.span("weights.read", model=model, bytes=os.path.getsize(npz_path)):
            return pytree_io.load_flat(npz_path)
    flat = convert()
    pytree_io.save_flat(npz_path, flat)
    return flat


def _on_device(build, flat: Dict[str, np.ndarray], device, model: str) -> torch.nn.Module:
    """The module ``build()`` makes on the host, loaded from ``flat``, then
    moved to ``device`` in one go."""
    with tracing.span("weights.build", model=model):
        module = build()
    with tracing.span("weights.load", model=model):
        load_flat(module, flat)
    with tracing.span("weights.to_device", model=model):
        return module.to(device)


def _random(build, model: str):
    """The module ``build()`` makes with its random initialisation."""
    with tracing.span("weights.build", model=model):
        return build()


def _cast(module: torch.nn.Module, conv_dtype: torch.dtype) -> torch.nn.Module:
    """The module with its conv kernels in ``conv_dtype`` (bfloat16), or as
    built (float32)."""
    return cast_conv_params(module, conv_dtype) if conv_dtype == torch.bfloat16 else module


# ---------------------------------------------------------------------------
# the models kept on their device across calls
# ---------------------------------------------------------------------------

_ROLES = {role: threading.Lock() for role in ("unet", "clip", "lpips")}  # a load at a time a role
_LOCK = threading.Lock()  # over _MODELS and _STATS, held only to read or write them
_MODELS: Dict[str, Tuple[tuple, object]] = {}  # role -> (key, what its loader returned)
_STATS = {"hits": 0, "misses": 0}
_thread = threading.local()


def _identity(path: str) -> Optional[tuple]:
    """The file as the key sees it, or None where there is none."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return os.path.abspath(path), st.st_size, st.st_mtime_ns, st.st_ino


def _key(files: Sequence[str], spec: tuple) -> Optional[tuple]:
    ids = tuple(_identity(f) for f in files)
    return None if None in ids else (ids, spec)


def _count(outcome: str) -> None:
    _STATS[outcome] += 1
    counts = getattr(_thread, "counts", None)
    if counts is not None:
        counts[outcome] += 1


def _kept(role: str, key: Optional[tuple]):
    """The kept model of ``role`` where its key is ``key`` (a hit), else None,
    the role's old entry dropped so its memory comes back before a load."""
    with _LOCK:
        kept = _MODELS.get(role)
        if key is not None and kept is not None and kept[0] == key:
            _count("hits")
            return kept[1]
        _MODELS.pop(role, None)
        return None


def _resident(role: str, files: Sequence[str], spec: tuple, load: Callable[[], object]):
    """What ``load()`` returns for ``role``: the kept one where ``files``
    (their identity) and ``spec`` (configuration, device, conv dtype) match
    its key, else a fresh one, kept in its place. Resolves of one role wait
    for each other (two misses on a key load once); the other roles' do not.
    A file missing before the load (a first use converts) is keyed as the
    load left it."""
    with _ROLES[role]:
        key = _key(files, spec)
        value = _kept(role, key)
        if value is not None:
            return value
        value = load()
        key = key or _key(files, spec)
        with _LOCK:
            _count("misses")
            if key is not None:
                _MODELS[role] = (key, value)
        return value


def clear_model_cache() -> None:
    """Drops every kept model (a caller that still holds one keeps it)."""
    with _LOCK:
        _MODELS.clear()


def cache_stats() -> Dict[str, int]:
    """The process's models served from the cache ("hits") and loaded
    ("misses"), random weights in neither."""
    with _LOCK:
        return dict(_STATS)


@contextlib.contextmanager
def cache_counts() -> Iterator[Dict[str, int]]:
    """A dict of the hits and misses of the calling thread's resolves inside
    the block, filled as they happen."""
    outer = getattr(_thread, "counts", None)
    _thread.counts = counts = {"hits": 0, "misses": 0}
    try:
        yield counts
    finally:
        _thread.counts = outer


def resolve_unet(
    image_size: int,
    class_cond: bool,
    mode: str = "random",
    flag_overrides: Optional[dict] = None,
    device="cuda",
    checkpoints_dir: str = CACHE_PATH,
    conv_dtype: torch.dtype = torch.float32,
) -> Tuple[UNet, UNetConfig, dict]:
    """Returns (unet, cfg, merged_flags), the flags merged as the reference
    does: registry defaults <- user overrides; the conv kernels in
    ``conv_dtype``. A checkpoint's UNet is the kept one where the key
    matches."""
    info = DIFFUSION_LOOKUP["cond" if class_cond else "uncond"][image_size]
    flags = dict(info["model_flags"])
    if flag_overrides:
        flags.update({k: v for k, v in flag_overrides.items() if v is not None})
    cfg = UNetConfig.from_flags(flags)
    if mode == "random":
        if os.environ.get("CGD_TPU_DEBUG_TINY"):
            cfg = dataclasses.replace(
                cfg, model_channels=32, num_res_blocks=1,
                channel_mult=(1, 2), attention_ds=(2,), num_head_channels=16,
                num_heads=1,
            )
        gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
        unet = _random(lambda: UNet(cfg, device=device).init_weights(gen), info["filename"])
        return _cast(unet, conv_dtype), cfg, flags

    pt_path = os.path.join(checkpoints_dir, info["filename"])
    npz_path = _converted_path(pt_path)

    def convert():
        if not os.path.exists(pt_path):
            download(info["url"], info["filename"], checkpoints_dir)
        from cgd_tpu_torch.convert.torch_unet import convert_unet_checkpoint

        return convert_unet_checkpoint(pt_path, cfg)

    def load():
        flat = _cached(npz_path, convert, info["filename"])
        return _cast(_on_device(lambda: UNet(cfg, device="cpu"), flat, device, info["filename"]),
                     conv_dtype)

    return _resident("unet", [npz_path], (cfg, torch.device(device), conv_dtype), load), cfg, flags


def resolve_clip(model_name: str, mode: str = "random", device="cuda",
                 checkpoints_dir: str = CACHE_PATH,
                 conv_dtype: torch.dtype = torch.float32) -> Tuple[CLIP, CLIPConfig]:
    """Any of the registry's CLIP models, ViT or ModifiedResNet, or a local
    ``.pt`` / ``.pth`` checkpoint; the conv kernels in ``conv_dtype``. A
    checkpoint's model is the kept one where the key matches."""
    if model_name.endswith((".pt", ".pth")):
        return _resolve_custom_clip(model_name, device, conv_dtype)
    cfg = CLIP_CONFIGS.get(model_name)
    if cfg is None:
        raise ValueError(
            f"Unknown CLIP model {model_name!r}; known: {sorted(CLIP_CONFIGS)} "
            "or a local .pt/.pth checkpoint path")
    if mode == "random":
        if os.environ.get("CGD_TPU_DEBUG_TINY"):
            cfg = dataclasses.replace(
                cfg,
                vision=VisionViTConfig(cfg.input_resolution, 32, 64, 2, 2),
                text=TextConfig(width=64, heads=2, layers=2),
                embed_dim=64,
            )
        gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
        model = _random(lambda: CLIP(cfg, device=device).init_weights(gen), model_name)
        return _cast(model, conv_dtype), cfg

    clip_dir = os.path.join(checkpoints_dir, "clip")
    filename = model_name.replace("/", "-") + ".pt"
    pt_path = os.path.join(clip_dir, filename)
    npz_path = _converted_path(pt_path)

    def convert():
        if not os.path.exists(pt_path):
            download(CLIP_MODEL_URLS[model_name], filename, clip_dir)
        from cgd_tpu_torch.convert.torch_clip import convert_clip_checkpoint

        return convert_clip_checkpoint(pt_path, cfg)

    def load():
        flat = _cached(npz_path, convert, model_name)
        return _cast(_on_device(lambda: CLIP(cfg, device="cpu"), flat, device, model_name),
                     conv_dtype)

    return _resident("clip", [npz_path], (cfg, torch.device(device), conv_dtype), load), cfg


def _resolve_custom_clip(pt_path: str, device, conv_dtype: torch.dtype) -> Tuple[CLIP, CLIPConfig]:
    """A local checkpoint, its configuration inferred from its shapes (and so
    keyed by the ``.pt`` file's identity beside its cache's)."""
    if not os.path.exists(pt_path):
        raise FileNotFoundError(pt_path)
    name = os.path.basename(pt_path)
    npz_path = _converted_path(pt_path)

    def load():
        from cgd_tpu_torch.convert.clip_config_infer import infer_clip_config
        from cgd_tpu_torch.convert.torch_clip import convert_state_dict, load_torch_clip_sd

        sd = load_torch_clip_sd(pt_path)
        cfg = infer_clip_config(sd, name=name)
        flat = _cached(npz_path, lambda: convert_state_dict(sd, cfg), name)
        return _cast(_on_device(lambda: CLIP(cfg, device="cpu"), flat, device, name),
                     conv_dtype), cfg

    return _resident("clip", [pt_path, npz_path], (torch.device(device), conv_dtype), load)


def resolve_lpips(mode: str = "random", device="cuda",
                  checkpoints_dir: str = CACHE_PATH) -> VGGLPIPS:
    """The LPIPS VGG16 weights: random, or torchvision's VGG16 and lpips'
    heads (the two ``.pth`` files looked up in, and downloaded to, the
    reference's cache) converted once into ``checkpoints_dir``'s
    ``lpips_vgg.npz.cgd``, kept where the key matches (its convs stay
    float32)."""
    if mode == "random":
        gen = torch.Generator(device).manual_seed(_WEIGHTS_SEED)
        return _random(lambda: VGGLPIPS(device=device).init_weights(gen), "lpips_vgg")
    from cgd_tpu_torch.convert.torch_lpips import convert_lpips

    npz_path = os.path.join(checkpoints_dir, "lpips_vgg.npz.cgd")

    def load():
        flat = _cached(npz_path, convert_lpips, "lpips_vgg")
        return _on_device(lambda: VGGLPIPS(device="cpu"), flat, device, "lpips_vgg")

    return _resident("lpips", [npz_path], (torch.device(device),), load)
