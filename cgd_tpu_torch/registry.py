"""Checkpoint registry: ADM diffusion checkpoints + CLIP model URLs — a copy
of ``cgd_tpu/registry.py`` (pure Python), so that the port imports nothing of
the JAX package. Pinned to the original by tests/test_torch_port_api.py.

The URLs/filenames/architecture flags are compatibility facts for the
published OpenAI / Katherine Crowson checkpoints (reference tables:
data/diffusion_model_flags.py and cgd/clip_util.py:20-29). Flag notes:
every checkpoint uses learn_sigma=True; 64px is the only cosine-schedule,
new-attention-order checkpoint (dropout 0.1, 3 res blocks); 128px is the only
num_heads(=4) checkpoint; 512px adds rescale_timesteps=True; user-supplied
noise_schedule/diffusion_steps/dropout override these (reference merge
order, cgd/script_util.py:307-315).
"""

from __future__ import annotations

from typing import Dict

_OPENAI = "https://openaipublic.blob.core.windows.net/diffusion/jul-2021"

_COMMON = {
    "attention_resolutions": "32,16,8",
    "diffusion_steps": 1000,
    "learn_sigma": True,
    "noise_schedule": "linear",
    "num_channels": 256,
    "num_head_channels": 64,
    "num_res_blocks": 2,
    "resblock_updown": True,
    "use_fp16": True,
    "use_scale_shift_norm": True,
}


def _entry(size: int, class_cond: bool, url: str, filename: str, **over) -> Dict:
    flags = dict(_COMMON)
    flags.update(image_size=size, class_cond=class_cond, **over)
    return {"url": url, "filename": filename, "model_flags": flags}


DIFFUSION_LOOKUP = {
    "cond": {
        64: _entry(
            64, True, f"{_OPENAI}/64x64_diffusion.pt", "64x64_diffusion.pt",
            noise_schedule="cosine", num_channels=192, num_res_blocks=3,
            dropout=0.1, use_new_attention_order=True,
        ),
        128: _entry(
            128, True, f"{_OPENAI}/128x128_diffusion.pt", "128x128_diffusion.pt",
            num_heads=4, num_head_channels=-1,
        ),
        256: _entry(256, True, f"{_OPENAI}/256x256_diffusion.pt", "256x256_diffusion.pt"),
        512: _entry(
            512, True, f"{_OPENAI}/512x512_diffusion.pt", "512x512_diffusion.pt",
            rescale_timesteps=True, timestep_respacing="1000",
        ),
    },
    "uncond": {
        256: _entry(
            256, False, f"{_OPENAI}/256x256_diffusion_uncond.pt",
            "256x256_diffusion_uncond.pt",
        ),
        512: _entry(
            512, False,
            "https://the-eye.eu/public/AI/models/512x512_diffusion_unconditional_ImageNet/"
            "512x512_diffusion_uncond_finetune_008100.pt",
            "512x512_diffusion_uncond_finetune_008100.pt",
            rescale_timesteps=True, timestep_respacing="1000",
        ),
    },
}

# OpenAI CLIP checkpoint URLs (reference: cgd/clip_util.py:20-29).
_CLIP_AZ = "https://openaipublic.azureedge.net/clip/models"
CLIP_MODEL_URLS = {
    "RN50": f"{_CLIP_AZ}/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": f"{_CLIP_AZ}/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": f"{_CLIP_AZ}/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": f"{_CLIP_AZ}/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "ViT-B/32": f"{_CLIP_AZ}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": f"{_CLIP_AZ}/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": f"{_CLIP_AZ}/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": f"{_CLIP_AZ}/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

CLIP_MODEL_NAMES = ("ViT-B/16", "ViT-B/32", "RN50", "RN101", "RN50x4", "RN50x16", "ViT-L/14")

# Validation constants (reference: cgd/script_util.py:19-22)
TIMESTEP_RESPACINGS = (
    "25", "50", "100", "250", "500", "1000",
    "ddim25", "ddim50", "ddim100", "ddim250", "ddim500", "ddim1000",
)
DIFFUSION_SCHEDULES = (25, 50, 100, 250, 500, 1000)
IMAGE_SIZES = (64, 128, 256, 512)
