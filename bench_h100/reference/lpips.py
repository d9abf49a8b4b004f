"""LPIPS(net='vgg') of the ``lpips`` package, version 0.1: its ScalingLayer,
torchvision's VGG16 ``features`` up to relu5_3 (taps after relu1_2,
relu2_2, relu3_3, relu4_3, relu5_3), each tap normalised over its channels
(``x / (sqrt(sum x^2) + 1e-10)``), the non-negative 1x1 heads
(``lin{i}.model.1.weight``), the mean over space summed over the taps.
Plain PyTorch in float32 under torchvision's and lpips' names.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.layers import F32, Conv2d, Operands, _param

# torchvision vgg16.features: the indices of its thirteen convs; the taps
# relu1_2 ... relu5_3 follow the convs in TAP_AFTER, and a 2x2 max-pool
# follows every tap but the last
CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
TAP_AFTER = (2, 7, 14, 21, 28)
TAP_WIDTHS = (64, 128, 256, 512, 512)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class _Head(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(OrderedDict([("0", nn.Identity())]))
        self.model.add_module("1", _Weight(c))


class _Weight(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = _param(1, c, 1, 1)


class LPIPSVGG(nn.Module):
    def __init__(self, ops: Operands = F32):
        super().__init__()
        cin, convs = 3, OrderedDict()
        for cid, c in zip(CONV_IDS, WIDTHS):
            convs[str(cid)] = Conv2d(cin, c, 3, ops, padding=1)
            cin = c
        self.features = nn.ModuleDict(convs)
        for i, c in enumerate(TAP_WIDTHS):
            setattr(self, f"lin{i}", _Head(c))
        self.ops = ops

    def taps(self, x):
        shift = torch.tensor(SHIFT, device=x.device)[None, :, None, None]
        scale = torch.tensor(SCALE, device=x.device)[None, :, None, None]
        h, out = (x - shift) / scale, []
        for cid in CONV_IDS:
            h = F.relu(self.features[str(cid)](h))
            if cid in TAP_AFTER:
                out.append(h)
                if cid != TAP_AFTER[-1]:
                    h = F.max_pool2d(h, 2)
        return out

    def forward(self, x, y):
        """x, y [B, 3, H, W] in [-1, 1] -> [B]."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self.taps(x), self.taps(y))):
            na = a / (a.square().sum(1, keepdim=True).sqrt() + 1e-10)
            nb = b / (b.square().sum(1, keepdim=True).sqrt() + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight
            d = self.ops(torch.einsum("bchw,c->bhw", self.ops((na - nb).square()),
                                      self.ops(w[0, :, 0, 0])))
            total = total + d.mean(dim=(1, 2))
        return total
