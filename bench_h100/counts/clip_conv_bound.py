"""The least time the card could take for the 3x3 convolutions of CLIP's
ModifiedResNet image tower (RN50 ... RN50x64) in one guided step: each
one's forward and its input gradient over cutn x batch cutouts, each bound
by the larger of its FLOPs over the bf16 dense peak and its bytes over the
HBM bandwidth. Bytes count each input and output of the function once, at
2 bytes (bf16): forward x, the weights and the output; input gradient dy,
the weights and dx.

``convs`` lists every conv of the tower with its shapes, in the published
layout (``reference/clip.py``; the tests hold it to the shapes walked on
the meta device): a stem of three 3x3 convs (the first of stride 2), then
four stages of bottlenecks (1x1, 3x3, 1x1, and a 1x1 projection of the skip
in each stage's first block), where a stride-2 block pools (2x2 average)
before its third 1x1 conv and before the skip's projection, so those convs
run at the pooled resolution. A ViT tower has none. ``seconds`` bounds the
3x3s alone (the stem's three and one a bottleneck): cuDNN runs those, and
``metrics/clip_conv_roofline.py`` reads its kernels; the port runs the 1x1s
as matmuls, whose kernels a trace cannot tell from the UNet's.
"""

from __future__ import annotations

from typing import List

BYTES = 2


def convs(vision: dict, n: int) -> List[dict]:
    """[{cin, cout, k, res_in, res_out, batch}] of the tower's convs, in
    forward order, for ``n`` images."""
    if vision["kind"] != "resnet":
        return []
    w, res = vision["width"], vision["resolution"]
    out = []

    def conv(cin, cout, k, res_in, res_out):
        out.append(dict(cin=cin, cout=cout, k=k, res_in=res_in, res_out=res_out, batch=n))

    conv(3, w // 2, 3, res, res // 2)
    res //= 2
    conv(w // 2, w // 2, 3, res, res)
    conv(w // 2, w, 3, res, res)
    res //= 2  # the stem's 2x2 average pool
    cin = w
    for i, (blocks, stride) in enumerate(zip(vision["layers"], (1, 2, 2, 2))):
        planes = w * 2 ** i
        for j in range(blocks):
            s = stride if j == 0 else 1
            conv(cin, planes, 1, res, res)
            conv(planes, planes, 3, res, res)
            conv(planes, 4 * planes, 1, res // s, res // s)
            if j == 0 and (s > 1 or cin != 4 * planes):
                conv(cin, 4 * planes, 1, res // s, res // s)
            cin, res = 4 * planes, res // s
    return out


def seconds(config: dict, call: dict, flops_peak: float, bytes_peak: float) -> float:
    """The bound of one guided step's 3x3 convs, in seconds; 0.0 for a ViT
    tower."""
    total = 0.0
    for c in convs(config["clip"]["vision"], call["num_cutouts"] * call["batch_size"]):
        if c["k"] != 3:
            continue
        b = c["batch"]
        f = 2 * b * c["res_out"] ** 2 * 9 * c["cin"] * c["cout"]
        x, y = b * c["res_in"] ** 2 * c["cin"], b * c["res_out"] ** 2 * c["cout"]
        moved = (x + 9 * c["cin"] * c["cout"] + y) * BYTES  # forward and dx alike
        total += 2 * max(f / flops_peak, moved / bytes_peak)
    return total
