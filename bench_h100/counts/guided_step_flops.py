"""FLOPs of one guided step of a configuration under a traffic mix, counted
from the shapes: the UNet forward and its input gradient, the cutouts'
two box-filter products, the CLIP image tower over cutn x batch cutouts
with its input gradient and, with an init image and ``init_scale``, the
LPIPS VGG16 over the blend (with its input gradient) and over the init
image (forward). 2 per multiply-add of every matmul, convolution and
attention product; no weight gradients, no elementwise work: what
``torch.utils.flop_counter`` counts over the reference's step (the tests
hold it to that). A frozen copy of ``cgd_tpu_torch/tools/bench.py``'s
``guided_step_flops`` with the LPIPS VGG added.
"""

from __future__ import annotations

from bench_h100.counts.adm_plan import heads, layers

LPIPS_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
LPIPS_POOL_AFTER = (1, 3, 6, 9)  # conv indices followed by a 2x2 max-pool
LPIPS_TAPS = (64, 128, 256, 512, 512)


class Flops:
    def __init__(self):
        self.total = 0

    def matmul(self, m, k, n, grads=1, count=1):
        """``count`` products [m, k] @ [k, n], and one more of the same size
        for each of ``grads`` operands that depend on x."""
        self.total += 2 * m * k * n * count * (1 + grads)

    def conv(self, n, hw, kk, cin, cout, grad=True):
        self.total += 2 * n * hw * kk * cin * cout * (2 if grad else 1)


def unet(acc: Flops, flags: dict, b: int) -> None:
    mc = flags["num_channels"]
    temb = 4 * mc
    acc.matmul(b, mc, temb, grads=0)
    acc.matmul(b, temb, temb, grads=0)
    for layer in layers(flags):
        kind = layer[0]
        if kind in ("conv_in", "out"):
            _, cin, cout, res = layer
            acc.conv(b, res * res, 9, cin, cout)
        elif kind == "res":
            _, cin, cout, mode, _, res = layer
            acc.conv(b, res * res, 9, cin, cout)
            acc.matmul(b, temb, 2 * cout, grads=0)
            if cin != cout:
                acc.matmul(b * res * res, cin, cout)
            acc.conv(b, res * res, 9, cout, cout)
        else:
            _, ch, res = layer
            t, h = res * res, heads(flags, ch)
            acc.matmul(b * t, ch, 3 * ch)
            acc.matmul(t, ch // h, t, grads=2, count=b * h)
            acc.matmul(t, t, ch // h, grads=2, count=b * h)
            acc.matmul(b * t, ch, ch)


def _block(acc: Flops, n: int, t: int, w: int, h: int) -> None:
    acc.matmul(n * t, w, 3 * w)
    acc.matmul(t, w // h, t, grads=2, count=n * h)
    acc.matmul(t, t, w // h, grads=2, count=n * h)
    acc.matmul(n * t, w, w)
    acc.matmul(n * t, w, 4 * w)
    acc.matmul(n * t, 4 * w, w)


def clip_image(acc: Flops, clip: dict, n: int) -> None:
    v, embed = clip["vision"], clip["embed_dim"]
    r = v["resolution"]
    if v["kind"] == "vit":
        grid = (r // v["patch"]) ** 2
        acc.matmul(n * grid, v["patch"] ** 2 * 3, v["width"])
        for _ in range(v["layers"]):
            _block(acc, n, grid + 1, v["width"], v["heads"])
        acc.matmul(n, v["width"], embed)
        return
    w = v["width"]
    res = r // 2
    for cin, cout in ((3, w // 2), (w // 2, w // 2), (w // 2, w)):
        acc.conv(n, res * res, 9, cin, cout)
    res //= 2
    cin = w
    for blocks, planes, stride in zip(v["layers"], (w, 2 * w, 4 * w, 8 * w), (1, 2, 2, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            out_res = res // s
            acc.conv(n, res * res, 1, cin, planes)
            acc.conv(n, res * res, 9, planes, planes)
            acc.conv(n, out_res * out_res, 1, planes, 4 * planes)
            if s > 1 or cin != 4 * planes:
                acc.conv(n, out_res * out_res, 1, cin, 4 * planes)
            cin, res = 4 * planes, out_res
    c, t = 32 * w, res * res + 1
    acc.matmul(n, c, c)
    acc.matmul(n * t, c, c, count=2)
    acc.matmul(1, c // v["heads"], t, grads=2, count=n * v["heads"])
    acc.matmul(1, t, c // v["heads"], grads=2, count=n * v["heads"])
    acc.matmul(n, c, embed)


def lpips(acc: Flops, b: int, size: int) -> None:
    """The VGG16 taps of the blend (forward and input gradient) and of the
    init image (forward), and the heads' products over the blend's taps."""
    res, cin, tap = size, 3, 0
    for i, c in enumerate(LPIPS_WIDTHS):
        acc.conv(b, res * res, 9, cin, c, grad=True)
        acc.conv(b, res * res, 9, cin, c, grad=False)
        cin = c
        if i in LPIPS_POOL_AFTER or i == len(LPIPS_WIDTHS) - 1:
            acc.matmul(b * res * res, LPIPS_TAPS[tap], 1)
            tap += 1
        if i in LPIPS_POOL_AFTER:
            res //= 2


def flops(config: dict, call: dict) -> int:
    """FLOPs of one guided step over the whole batch."""
    b, size, cutn = call["batch_size"], config["unet"]["image_size"], call["num_cutouts"]
    cut = config["clip"]["vision"]["resolution"]
    acc = Flops()
    unet(acc, config["unet"], b)
    acc.matmul(cutn * cut, size, b * size * 3)
    acc.matmul(cut, size, b * cut * 3, count=cutn)
    clip_image(acc, config["clip"], cutn * b)
    if call.get("init_scale"):
        lpips(acc, b, size)
    return acc.total
