"""The conv family's launch plan (``kernels.conv3x3.conv_plan``) on the CPU.

The plan is the geometry that the wrapper and the CUDA kernel must agree on
(8 x 16 output patches, the N tile, the Cin chunks, split K, the TMA boxes
and the shared memory). These tests hold it, for every 3x3 conv of the 256px
and 512px UNets (forward and backward), of the same UNets split in two by
height (K-halo), and of the ragged shapes of the card tests, to what the
kernel needs: every output pixel covered once, every tap inside the staged
window, shared memory within a block's 227 KB, TMA boxes and strides the
hardware takes, and no empty split. The shapes come from the full-size
UNets run on the ``meta`` device with the conv and attention calls recorded.
"""

import numpy as np
import pytest
import torch

from cgd_tpu_torch.kernels import attention as kattn
from cgd_tpu_torch.kernels import conv3x3 as k3

SMS = (132, 114)  # H100 SXM, H100 PCIe


def _unet_convs(size):
    """(b, h, w, cin, cout, up, prologue) of every K-fwd call of the
    full-size class-conditional UNet's forward at ``size`` px."""
    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    rec = []

    def fwd(x, w, bias, A=None, B=None, skip=None, up=False, etop=None, ebot=None):
        b, h, wd, ci = x.shape
        rec.append((b, h, wd, ci, w.shape[-1], up, A is not None))
        ho, wo = (2 * h, 2 * wd) if up else (h, wd)
        return torch.empty(b, ho, wo, w.shape[-1], dtype=x.dtype, device=x.device)

    saved = k3.conv3x3_fwd, kattn.qkv_attention
    k3.conv3x3_fwd = fwd
    kattn.qkv_attention = lambda qkv, n: qkv[..., : qkv.shape[-1] // 3]
    try:
        cfg = UNetConfig.from_flags(DIFFUSION_LOOKUP["cond"][size]["model_flags"])
        unet = UNet(cfg, device="meta")
        x = torch.empty(1, size, size, 3, device="meta")
        unet(x, torch.zeros(1, device="meta"), torch.zeros(1, dtype=torch.long, device="meta"),
             compute_dtype=torch.bfloat16)
    finally:
        k3.conv3x3_fwd, kattn.qkv_attention = saved
    return sorted(set(rec))


def _with_backward(convs):
    """The forward launches plus those of their input gradients, as the
    autograd Functions make them: K-dx for the prologue convs (Cg = Cout,
    Cx = Cin), K-fwd with the flipped weight otherwise (at the output size
    for up). Entries: (kind, b, h, w, cin, cout, up, prologue, halo)."""
    out = []
    for b, h, w, ci, co, up, pro in convs:
        out.append(("fwd", b, h, w, ci, co, up, pro, False))
        if pro and not up:
            out.append(("dx", b, h, w, co, ci, False, False, False))
        else:
            s = 2 if up else 1
            out.append(("fwd", b, s * h, s * w, co, ci, False, False, False))
    return out


def _split(launches, cut=2):
    """The same UNet split by height over ``cut`` shards: every conv runs as
    K-halo on a shard (the split UNet upsamples before the conv, and its
    backward is K-halo with the flipped weight)."""
    out = []
    for kind, b, h, w, ci, co, up, pro, _ in launches:
        s = 2 if up else 1
        if (s * h) % cut == 0:
            out.append(("fwd", b, s * h // cut, s * w, ci, co, False, pro and kind == "fwd", True))
    return out


# the ragged and skinny shapes of tests/test_torch_port_cuda.py
_RAGGED = (
    [("fwd", b, h, h, ci, co, up, pro, False) for b, h, ci, co in
     [(2, 24, 64, 96), (1, 16, 3, 256), (1, 32, 256, 6), (1, 8, 1024, 512)]
     for up, pro in [(False, False), (False, True), (True, True)]]
    + [("dx", b, h, w, ci, co, False, False, False) for b, h, w, ci, co in
       [(1, 64, 512, 128, 128), (1, 24, 40, 64, 96), (2, 9, 33, 32, 8), (1, 8, 12, 256, 16)]]
    + [("fwd", b, h, w, ci, co, False, pro, True) for b, h, w, ci, co in
       [(2, 12, 20, 64, 96), (1, 16, 16, 3, 256), (1, 1, 8, 32, 8), (1, 8, 16, 1024, 512)]
       for pro in (False, True)]
)


@pytest.fixture(scope="module")
def groups():
    u256 = _with_backward(_unet_convs(256))
    u512 = _with_backward(_unet_convs(512))
    return {"unet256": u256, "unet512": u512, "split256": _split(u256),
            "split512": _split(u512), "ragged": _RAGGED}


GROUPS = ["unet256", "unet512", "split256", "split512", "ragged"]


def _plans(launches):
    for kind, b, h, w, ci, co, up, pro, halo in launches:
        for sms in SMS:
            plan = k3.conv_plan(b, h, w, ci, co, up=up, halo=halo, sms=sms)
            yield (kind, b, h, w, ci, co, up, pro, halo, sms), plan


def test_the_unet_shapes_are_found(groups):
    u256, u512 = groups["unet256"], groups["unet512"]
    assert ("fwd", 1, 256, 256, 256, 256, False, True, False) in u256
    assert ("fwd", 1, 512, 512, 128, 128, False, True, False) in u512
    assert ("dx", 1, 512, 512, 128, 256, False, False, False) in u512
    assert any(e[6] for e in u256) and groups["split512"]


@pytest.mark.parametrize("group", GROUPS)
def test_every_output_pixel_is_covered_once(groups, group):
    for key, plan in _plans(groups[group]):
        ho, wo = plan["ho"], plan["wo"]
        ph, pw = plan["patch"]
        tiles_x = -(-wo // pw)
        count = np.zeros((ho, wo), np.int32)
        for t in range(plan["grid"][0]):
            y0, x0 = (t // tiles_x) * ph, (t % tiles_x) * pw
            assert y0 < ho and x0 < wo, key  # no patch lies wholly outside
            count[y0:y0 + ph, x0:x0 + pw] += 1
        assert (count == 1).all(), key
        ntiles = plan["grid"][1]
        assert (ntiles - 1) * plan["bn"] < plan["cout"] <= ntiles * plan["bn"], key
        assert plan["grid"][2] == key[1] * plan["ksplit"], key


def _window(plan, up, y0, x0):
    """Input rows and columns the staged patch holds for the patch at (y0,
    x0) (source coordinates with up): ``window`` rows of one-row boxes."""
    rh, rw = plan["window"]
    assert plan["box_x"] == (plan["bk"], rw, 1, 1)
    ys, xs = (y0 // 2 - 1, x0 // 2 - 1) if up else (y0 - 1, x0 - 1)
    return range(ys, ys + rh), range(xs, xs + rw)


@pytest.mark.parametrize("group", GROUPS)
def test_the_staged_patch_holds_every_tap(groups, group):
    for key, plan in _plans(groups[group]):
        up, halo = key[6], key[8]
        h = key[2]
        ph, pw = plan["patch"]
        tiles_x = -(-plan["wo"] // pw)
        for t in {0, tiles_x - 1, plan["grid"][0] - 1}:
            y0, x0 = (t // tiles_x) * ph, (t % tiles_x) * pw
            rows, cols = _window(plan, up, y0, x0)
            for oy in range(y0, y0 + ph):
                for ky in range(3):
                    iy = oy + ky - 1
                    assert (iy >> 1 if up else iy) in rows, (key, oy, ky)
                    if halo and iy in (-1, h):  # a neighbour's row: one-row box
                        assert plan["box_halo"] == (plan["bk"], plan["box_x"][1], 1, 1), key
            for ox in range(x0, x0 + pw):
                for kx in range(3):
                    ix = ox + kx - 1
                    assert (ix >> 1 if up else ix) in cols, (key, ox, kx)
        if not halo:
            assert plan["box_halo"] is None, key


@pytest.mark.parametrize("group", GROUPS)
def test_shared_memory_fits_one_block(groups, group):
    for key, plan in _plans(groups[group]):
        assert plan["smem_bytes"] <= k3.SMEM_MAX - 256, key
        assert plan["b_stages"] >= 2, key
        # three A stages of the staged window, the B ring, 1 KB alignment slack
        rh, rw = plan["window"]
        a_bytes = 3 * rh * rw * plan["bk"] * 2
        assert plan["smem_bytes"] >= a_bytes + plan["b_stages"] * plan["bk"] * plan["bn"] * 2


@pytest.mark.parametrize("group", GROUPS)
def test_tma_boxes_and_strides(groups, group):
    for key, plan in _plans(groups[group]):
        assert plan["cin"] % plan["bk"] == 0 and plan["cout"] % 8 == 0, key
        inner_x = plan["box_x"][0] * 2
        assert inner_x % 16 == 0 and inner_x <= plan["swizzle_x"], key
        assert plan["box_w"][0] * 2 <= plan["swizzle_w"], key
        assert all(s % 16 == 0 for s in plan["strides_x"]) and plan["stride_w"] % 16 == 0, key
        assert all(1 <= d <= 256 for d in plan["box_x"] + plan["box_w"]), key
        # wgmma's N is the tile; the weight box tiles it exactly
        assert plan["bn"] % plan["box_w"][0] == 0 and plan["bn"] % 8 == 0, key


@pytest.mark.parametrize("group", GROUPS)
def test_split_k_ranges_are_never_empty(groups, group):
    for key, plan in _plans(groups[group]):
        n, ks = plan["chunks"], plan["ksplit"]
        assert 1 <= ks <= n, key
        bounds = [s * n // ks for s in range(ks + 1)]  # as make_geom splits
        assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:])), key
        if ks > 1:
            assert n // ks >= 2, key  # at least two chunks a split


def test_split_k_only_where_the_tiles_do_not_fill_the_card():
    big = k3.conv_plan(1, 256, 256, 256, 256)
    assert big["ksplit"] == 1 and big["bn"] == 256 and big["grid"] == (512, 1, 1)
    small = k3.conv_plan(1, 16, 16, 2048, 1024)
    assert small["grid"][:2] == (2, 4) and small["ksplit"] == 16
    assert k3.conv_plan(1, 16, 16, 2048, 1024, split=False)["ksplit"] == 1


@pytest.mark.parametrize("cout,bn", [(6, 16), (8, 16), (16, 16), (24, 128), (96, 128),
                                     (128, 128), (136, 256), (256, 256), (1024, 256)])
def test_the_n_tile_follows_cout(cout, bn):
    plan = k3.conv_plan(1, 64, 64, 128, cout)
    assert plan["bn"] == bn == k3.tile_n(plan["cout"])
    assert plan["swizzle_w"] == (32 if bn == 16 else 128)


def test_skinny_cin_pads_to_one_chunk():
    plan = k3.conv_plan(1, 256, 256, 3, 256)
    assert plan["cin"] == 64 and plan["chunks"] == 1 and plan["ksplit"] == 1


# the 13 convs of the LPIPS VGG16 at a 256^2 input (H, Cin, Cout), and the
# input gradient of the first (Cout 3)
VGG16_256 = [(256, 3, 64), (256, 64, 64), (128, 64, 128), (128, 128, 128), (64, 128, 256),
             (64, 256, 256), (64, 256, 256), (32, 256, 512), (32, 512, 512), (32, 512, 512),
             (16, 512, 512), (16, 512, 512), (16, 512, 512), (256, 64, 3)]


@pytest.mark.parametrize("h,cin,cout", VGG16_256)
def test_the_f32_plan_covers_the_vgg16_convs(h, cin, cout):
    """K-fwd f32: Cin / Cout padded to multiples of 4 (16-byte copies), the
    grid covering every output pixel and channel once, Cin in 32-channel
    chunks, two stages of the staged window and weights within a block's
    shared memory."""
    for b in (1, 2):
        plan = k3.f32_plan(b, h, h, cin, cout)
        assert plan["cin"] % 4 == 0 and plan["cin"] - cin < 4
        assert plan["cout"] % 4 == 0 and plan["cout"] - cout < 4
        patches, ntiles, nb = plan["grid"]
        ph, pw = plan["patch"]
        assert patches == -(-h // ph) * -(-h // pw)
        assert ntiles * plan["bn"] >= plan["cout"] > (ntiles - 1) * plan["bn"] and nb == b
        assert plan["chunks"] * plan["bk"] >= plan["cin"] > (plan["chunks"] - 1) * plan["bk"]
        assert plan["smem_bytes"] == 217728 <= k3.SMEM_MAX


# K-fwd f32 in every mode and K-dx f32: what compute_dtype="float32" runs for
# every 3x3 conv of the 128, 256 and 512px trees, forward and backward
F32_TREES = (128, 256, 512)


@pytest.fixture(scope="module")
def f32_launches():
    return {size: _with_backward(_unet_convs(size)) for size in F32_TREES}


def _f32_plans(launches):
    for kind, b, h, w, ci, co, up, pro, _ in launches:
        yield (kind, b, h, w, ci, co, up, pro), k3.f32_plan(b, h, w, ci, co, up=up,
                                                             dx=kind == "dx")


def test_the_f32_trees_hold_every_mode(f32_launches):
    for size in F32_TREES:
        kinds = {(kind, up, pro) for kind, _, _, _, _, _, up, pro, _ in f32_launches[size]}
        assert {("fwd", False, False), ("fwd", False, True), ("fwd", True, True),
                ("dx", False, False)} <= kinds, size


@pytest.mark.parametrize("size", F32_TREES)
def test_the_f32_plan_covers_every_output_once(f32_launches, size):
    """The grid's 8 x 16 patches tile the output (2h x 2w with up) once, its
    N tiles cover Cout, its chunks Cin (both padded to multiples of 4)."""
    for key, plan in _f32_plans(f32_launches[size]):
        kind, b, h, w, ci, co, up, _ = key
        assert (plan["ho"], plan["wo"]) == ((2 * h, 2 * w) if up else (h, w)), key
        ph, pw = plan["patch"]
        tiles_x = -(-plan["wo"] // pw)
        count = np.zeros((plan["ho"], plan["wo"]), np.int32)
        for t in range(plan["grid"][0]):
            y0, x0 = (t // tiles_x) * ph, (t % tiles_x) * pw
            assert y0 < plan["ho"] and x0 < plan["wo"], key
            count[y0:y0 + ph, x0:x0 + pw] += 1
        assert (count == 1).all(), key
        assert plan["cin"] % 4 == 0 and 0 <= plan["cin"] - ci < 4, key
        assert plan["cout"] % 4 == 0 and 0 <= plan["cout"] - co < 4, key
        ntiles = plan["grid"][1]
        assert (ntiles - 1) * plan["bn"] < plan["cout"] <= ntiles * plan["bn"], key
        assert (plan["chunks"] - 1) * plan["bk"] < plan["cin"] <= plan["chunks"] * plan["bk"], key
        assert plan["grid"][2] == b, key


@pytest.mark.parametrize("size", F32_TREES)
def test_the_f32_window_holds_every_tap(f32_launches, size):
    """The staged window of a patch at (y0, x0) starts at source row / col
    (y0 - 1, x0 - 1), with up (y0 / 2 - 1, x0 / 2 - 1); it holds exactly the
    rows and columns the patch's taps read, and the kernel's fragment
    address (window row (py + dy + 1) / 2 with up) names the right one."""
    for key, plan in _f32_plans(f32_launches[size]):
        up = key[6]
        rh, rw = plan["window"]
        assert (rh, rw) == ((6, 10) if up else (10, 18)), key
        ph, pw = plan["patch"]
        for y0 in (0, ph, plan["ho"] - ph):
            ys = y0 // 2 - 1 if up else y0 - 1
            needed = set()
            for py in range(ph):
                for dy in range(3):
                    src = (y0 + py + dy - 1) // 2 if up else y0 + py + dy - 1
                    needed.add(src)
                    row = (py + dy + 1) // 2 if up else py + dy
                    assert ys + row == src, (key, y0, py, dy)
            assert needed == set(range(ys, ys + rh)), key
        for x0 in (0, pw):
            xs = x0 // 2 - 1 if up else x0 - 1
            for px in range(pw):
                for dx in range(3):
                    src = (x0 + px + dx - 1) // 2 if up else x0 + px + dx - 1
                    col = (px + dx + 1) // 2 if up else px + dx
                    assert xs + col == src and 0 <= col < rw, (key, x0, px, dx)


@pytest.mark.parametrize("size", F32_TREES)
def test_the_f32_plan_fits_one_block_and_sizes_kdx(f32_launches, size):
    """Every mode takes the plain window's shared memory (two stages of the
    10 x 18 window and the weights), within a block's 227 KB; K-dx f32 writes
    one dA/dB partial row per output patch."""
    for key, plan in _f32_plans(f32_launches[size]):
        assert plan["smem_bytes"] == 217728 <= k3.SMEM_MAX, key
        rh, rw = plan["window"]
        assert rh * rw <= 10 * 18, key
        if key[0] == "dx":
            assert plan["partial_rows"] == plan["grid"][0], key
        else:
            assert plan["partial_rows"] is None, key


# K-halo f32: every conv of the 256px and 512px trees split by height, as
# the split UNet runs them at compute_dtype="float32" (forward, and the
# backward's flipped-weight conv)
HALO_SPLITS = [(size, cut) for size in (256, 512) for cut in (2, 4)]


@pytest.mark.parametrize("size,cut", HALO_SPLITS)
def test_the_f32_halo_plan_takes_rows_minus_1_and_h_from_the_neighbours(f32_launches, size,
                                                                        cut):
    """f32_plan(halo=True) on every K-halo launch of the split tree: window
    rows -1 and h come from etop / ebot, rows inside the shard from x, and
    every tap of a written output (patch rows past a short shard's h are
    never written) lands on one of those, inside the 10 x 18 window; K-halo
    takes the same shared memory as every other f32 mode."""
    halo = _split(f32_launches[size], cut)
    assert min(key[2] for key in halo) == 8 // cut < k3.F32_PATCH[0]  # the 8^2 level's shards
    for key in halo:
        _, b, h, w, ci, co, up, _, is_halo = key
        assert is_halo and not up, key
        plan = k3.f32_plan(b, h, w, ci, co, halo=True)
        assert plan["halo_rows"] == {-1: "etop", h: "ebot"}, key
        assert plan["window"] == (10, 18) and plan["smem_bytes"] == 217728, key
        ph, _ = plan["patch"]
        sources = set()
        for y0 in range(0, plan["ho"], ph):
            window = range(y0 - 1, y0 - 1 + plan["window"][0])
            for oy in range(y0, min(y0 + ph, h)):
                for dy in range(3):
                    iy = oy + dy - 1
                    assert iy in window, (key, oy, dy)
                    src = "x" if 0 <= iy < h else plan["halo_rows"].get(iy)
                    assert src is not None, (key, oy, dy)
                    sources.add(src)
        assert sources == {"x", "etop", "ebot"}, key

