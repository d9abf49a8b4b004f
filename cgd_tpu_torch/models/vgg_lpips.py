"""VGG16 feature taps and the LPIPS perceptual distance, counterpart of
``cgd_tpu/models/vgg_lpips.py`` (lpips 0.1.4's ``LPIPS(net='vgg')``, which
the reference calls as ``lpips_vgg(x_in, init_tensor)`` on [-1, 1] images):
the ScalingLayer, torchvision's VGG16 features with taps after relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3, each tap unit-normalised over its
channels, non-negative 1x1 heads, the mean over space summed over the taps.

The module tree follows the JAX parameter pytree (``convs.N.kernel`` HWIO,
``convs.N.bias``, ``lins.N.kernel`` [C, 1]), so ``.npz.cgd`` caches carry
across. Activations are NHWC f32. The 3x3 convs go through
``ops.nn.conv2d``: on the kernel route a CUDA tensor runs K-fwd f32
(``csrc/conv3x3_f32.cu``), forward and input gradient, as the JAX package's
f32 convs reach its Pallas kernel. The max-pool is plain ``F.max_pool2d``
(the JAX package's ``reduce_window``). ``ops.nn.cast_conv_params`` is never
applied to this tree: the distance runs in f32.
"""

from __future__ import annotations

import functools
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from cgd_tpu_torch.models.unet import Conv, _empty
from cgd_tpu_torch.ops import nn as cnn

# channels per conv layer, 'M' = 2x2 max-pool (the VGG16 feature stack)
VGG16_LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
TAP_AFTER_CONV = [1, 3, 6, 9, 12]  # 0-based conv index of each tap
TAP_CHANNELS = [64, 128, 256, 512, 512]

# lpips 0.1.4's ScalingLayer, input in [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Lin(nn.Module):
    """A non-negative 1x1 head, kernel [C, 1]."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.kernel = _empty((c, 1), device, torch.float32)


class VGGLPIPS(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        convs, cin = [], 3
        for c in VGG16_LAYOUT:
            if c != "M":
                convs.append(Conv(3, 3, cin, c, device=device))
                cin = c
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ModuleList(_Lin(c, device) for c in TAP_CHANNELS)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "VGGLPIPS":
        """Random weights (``init_vgg_lpips``'s scales): conv kernels uniform
        in +-1/sqrt(fan_in), zero bias, heads |normal| * 0.1."""
        for conv in self.convs:
            conv.init_weights(gen)
        for lin in self.lins:
            lin.kernel.normal_(generator=gen).abs_().mul_(0.1)
        return self


def vgg_taps(model: VGGLPIPS, x: torch.Tensor) -> List[torch.Tensor]:
    """The five relu taps of NHWC ``x``."""
    taps, h, i = [], x, 0
    for c in VGG16_LAYOUT:
        if c == "M":
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
            continue
        h = torch.relu(cnn.conv2d(model.convs[i], h))
        if i in TAP_AFTER_CONV:
            taps.append(h)
        i += 1
    return taps


@functools.lru_cache(maxsize=None)
def _shift_scale(device: torch.device):
    """LPIPS' input shift and scale on ``device``, made once: a step that
    a CUDA graph replays copies nothing from the host."""
    return (torch.tensor(_SHIFT, dtype=torch.float32, device=device),
            torch.tensor(_SCALE, dtype=torch.float32, device=device))


def lpips_distance(model: VGGLPIPS, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Perceptual distance of x and y, [B, H, W, 3] in [-1, 1] -> [B]."""
    shift, scale = _shift_scale(x.device)

    def prep(im):
        return (im.float() - shift) / scale

    total = 0.0
    for tx, ty, lin in zip(vgg_taps(model, prep(x)), vgg_taps(model, prep(y)), model.lins):
        # lpips' normalize_tensor: x / (sqrt(sum x^2) + eps), eps outside the sqrt
        nx = tx / (tx.square().sum(-1, keepdim=True).sqrt() + 1e-10)
        ny = ty / (ty.square().sum(-1, keepdim=True).sqrt() + 1e-10)
        per_pix = (nx - ny).square() @ lin.kernel[:, 0]
        total = total + per_pix.mean(dim=(1, 2))
    return total
