"""LPIPS(net='vgg') converter: torchvision's VGG16 features and lpips' linear
heads -> the port's ``models.vgg_lpips.VGGLPIPS`` parameters, counterpart
of ``cgd_tpu/convert/torch_lpips.py``. Either ``.pth`` not given is looked
up in the checkpoint cache and downloaded there if missing, as the JAX
package does; ``weights.resolve_lpips`` caches the result as a flat npz.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cgd_tpu_torch.io_utils.download import CACHE_PATH, download

VGG16_URL = "https://download.pytorch.org/models/vgg16-397923af.pth"
# lpips 0.1.4's bundled linear weights (v0.1)
LPIPS_VGG_URL = (
    "https://github.com/richzhang/PerceptualSimilarity/raw/master/lpips/weights/v0.1/vgg.pth"
)
# torchvision vgg16: the thirteen convs of ``features``
CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def convert_state_dicts(vgg_sd, lin_sd) -> Dict[str, np.ndarray]:
    """torchvision ``features.N.{weight,bias}`` and lpips
    ``lin{i}.model.1.weight`` (numpy or tensor values) -> the port's flat
    parameter dict."""
    out: Dict[str, np.ndarray] = {}
    for i, cid in enumerate(CONV_IDS):
        w = np.asarray(vgg_sd[f"features.{cid}.weight"], dtype=np.float32)
        out[f"convs.{i}.kernel"] = np.transpose(w, (2, 3, 1, 0))
        out[f"convs.{i}.bias"] = np.asarray(vgg_sd[f"features.{cid}.bias"], dtype=np.float32)
    for i in range(5):
        w = np.asarray(lin_sd[f"lin{i}.model.1.weight"], dtype=np.float32)  # [1, C, 1, 1]
        out[f"lins.{i}.kernel"] = w[0, :, 0, 0][:, None]
    return out


def convert_lpips(vgg_path: str = None, lin_path: str = None) -> Dict[str, np.ndarray]:
    import torch

    if vgg_path is None:
        vgg_path = download(VGG16_URL, "vgg16-397923af.pth", CACHE_PATH)
    if lin_path is None:
        lin_path = download(LPIPS_VGG_URL, "lpips_vgg_v0.1.pth", CACHE_PATH)
    return convert_state_dicts(torch.load(vgg_path, map_location="cpu"),
                               torch.load(lin_path, map_location="cpu"))
