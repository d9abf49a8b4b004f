"""The conv family's launch plan (``kernels.conv3x3.conv_plan``) on the CPU.

The plan is the geometry that the wrapper and the CUDA kernel must agree on
(8 x 16 output patches, the N tile, the Cin chunks, split K, the TMA boxes
and the shared memory). These tests hold it, for every 3x3 conv of the 64px,
256px and 512px UNets (forward and backward), of the same UNets split in two
by height (K-halo), and of the ragged shapes of the card tests, to what the
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
    u64 = _with_backward(_unet_convs(64))
    return {"unet256": u256, "unet512": u512, "split256": _split(u256),
            "split512": _split(u512), "ragged": _RAGGED, "unet64": u64,
            "split64": _split(u64)}


GROUPS = ["unet256", "unet512", "split256", "split512", "ragged", "unet64", "split64"]


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


def _epilogue_columns(plan, tile):
    """The output channels the bf16 epilogues write for N tile ``tile``
    (csrc/conv3x3_fwd.cu:58-61, conv3x3_dx.cu's dx stream and its dA / dB
    partial row, conv3x3_common.cuh's store_partial): thread group ``grp``
    owns the 8 channels from n0 + 8 grp, n0 = tile * bn, and writes them
    only if that start is below Cout (padded to 8); a dA / dB column ct of
    the block is written only if n0 + ct is below Cx."""
    n0, bn, cout = tile * plan["bn"], plan["bn"], plan["cout"]
    groups = [c for g in range(bn // 8) if n0 + 8 * g < cout for c in range(n0 + 8 * g,
                                                                          n0 + 8 * g + 8)]
    partial = [n0 + ct for ct in range(bn) if n0 + ct < cout]
    return groups, partial


def test_the_64px_shapes_are_found(groups):
    """The 64px model's convs (192 / 384 / 576 / 768 channels, the 6-channel
    output conv) reach the plan, forward and backward."""
    u64 = groups["unet64"]
    assert ("fwd", 1, 64, 64, 3, 192, False, False, False) in u64
    assert ("fwd", 1, 64, 64, 192, 192, False, True, False) in u64
    assert ("fwd", 1, 16, 16, 576, 576, False, True, False) in u64
    assert ("fwd", 1, 8, 8, 768, 768, False, True, False) in u64
    assert ("fwd", 1, 64, 64, 192, 6, False, True, False) in u64
    assert {("dx", 192), ("dx", 384), ("dx", 576)} <= {(e[0], e[5]) for e in u64}
    assert any(e[6] for e in u64)


@pytest.mark.parametrize("cout,ntiles,dead", [(192, 1, 64), (384, 2, 128), (576, 3, 192),
                                              (768, 3, 0), (6, 1, 8)])
def test_partly_filled_n_tiles_write_every_channel_once_and_none_past_cout(groups, cout,
                                                                          ntiles, dead):
    """The 64px model's output widths fill their 256-wide N tiles partly:
    192 runs one tile with 64 dead columns, 384 its second tile half empty,
    576 a third tile with 64 live columns (the 6-channel output conv pads to
    8 in a 16-wide tile). Over every such launch of the 64px tree (K-fwd in
    each mode, K-dx at Cx = 192 / 384 / 576, split K or not) the epilogues
    write each output channel exactly once and none at or past Cout, and
    the dead share of the tiles' columns is what PERF.md states."""
    seen = 0
    for key, plan in _plans(groups["unet64"]):
        if plan["cout"] != _round8(cout):
            continue
        seen += 1
        assert plan["grid"][1] == ntiles, key
        assert ntiles * plan["bn"] - plan["cout"] == dead, key
        written, partial = np.zeros(plan["cout"] + plan["bn"], np.int32), []
        for tile in range(plan["grid"][1]):
            cols, part = _epilogue_columns(plan, tile)
            np.add.at(written, cols, 1)
            partial += part
        assert (written[:plan["cout"]] == 1).all() and not written[plan["cout"]:].any(), key
        assert sorted(partial) == list(range(plan["cout"])), key
    assert seen


def _round8(n):
    return -(-n // 8) * 8


def test_skinny_cin_pads_to_one_chunk():
    plan = k3.conv_plan(1, 256, 256, 3, 256)
    assert plan["cin"] == 64 and plan["chunks"] == 1 and plan["ksplit"] == 1


# the 13 convs of the LPIPS VGG16 at a 256^2 input (H, Cin, Cout), and the
# input gradient of the first (Cout 3)
VGG16_256 = [(256, 3, 64), (256, 64, 64), (128, 64, 128), (128, 128, 128), (64, 128, 256),
             (64, 256, 256), (64, 256, 256), (32, 256, 512), (32, 512, 512), (32, 512, 512),
             (16, 512, 512), (16, 512, 512), (16, 512, 512), (256, 64, 3)]


def _f32_smem(plan):
    """What the plan's rings take: window stages of ``window`` rows in
    1 KB-aligned slots, slab stages of bn rows x 32 channels, hi and lo, and
    1 KB of alignment slack."""
    rows, cols = plan["window"]
    assert plan["slot"] % 1024 == 0 and cols * 128 <= plan["slot"] < cols * 128 + 1024
    return (plan["win_stages"] * rows * plan["slot"]
            + plan["slab_stages"] * 2 * plan["bn"] * 128 + 1024)


@pytest.mark.parametrize("h,cin,cout", VGG16_256)
def test_the_f32_plan_covers_the_vgg16_convs(h, cin, cout):
    """K-fwd f32: Cin / Cout padded to multiples of 4 (16-byte TMA strides),
    the grid covering every output pixel and channel once, Cin in
    32-channel chunks, the rings within a block's shared memory."""
    for b in (1, 2):
        plan = k3.f32_plan(b, h, h, cin, cout)
        assert plan["cin"] % 4 == 0 and plan["cin"] - cin < 4
        assert plan["cout"] % 4 == 0 and plan["cout"] - cout < 4
        patches, ntiles, nb = plan["tile_grid"]
        ph, pw = plan["patch"]
        assert ph * pw == k3.F32_BM and patches == -(-h // ph) * -(-h // pw)
        assert ntiles * plan["bn"] >= plan["cout"] > (ntiles - 1) * plan["bn"]
        assert nb == b * plan["ksplit"]
        assert plan["chunks"] * plan["bk"] >= plan["cin"] > (plan["chunks"] - 1) * plan["bk"]
        assert plan["smem_bytes"] == _f32_smem(plan) <= k3.SMEM_MAX - k3.F32_STATIC


# K-fwd f32 in every mode and K-dx f32: what compute_dtype="float32" runs for
# every 3x3 conv of the 64, 128, 256 and 512px trees, forward and backward
F32_TREES = (64, 128, 256, 512)


@pytest.fixture(scope="module")
def f32_launches():
    return {size: _with_backward(_unet_convs(size)) for size in F32_TREES}


def _f32_plans(launches):
    for kind, b, h, w, ci, co, up, pro, halo in launches:
        for sms in SMS:
            yield (kind, b, h, w, ci, co, up, pro, halo, sms), k3.f32_plan(
                b, h, w, ci, co, up=up, dx=kind == "dx", halo=halo, sms=sms)


# K-halo f32: every conv of the 256px and 512px trees split by height, as
# the split UNet runs them at compute_dtype="float32" (forward, and the
# backward's flipped-weight conv)
HALO_SPLITS = [(size, cut) for size in (256, 512) for cut in (2, 4)]
F32_GROUPS = [f"tree{size}" for size in F32_TREES] + [f"split{size}-cut{cut}"
                                                      for size, cut in HALO_SPLITS]


def _f32_group(f32_launches, group):
    if group.startswith("tree"):
        return f32_launches[int(group[4:])]
    size, cut = group[5:].split("-cut")
    return _split(_with_backward(_unet_convs(int(size))), int(cut))


def test_the_f32_trees_hold_every_mode(f32_launches):
    for size in F32_TREES:
        kinds = {(kind, up, pro) for kind, _, _, _, _, _, up, pro, _ in f32_launches[size]}
        assert {("fwd", False, False), ("fwd", False, True), ("fwd", True, True),
                ("dx", False, False)} <= kinds, size


@pytest.mark.parametrize("size", F32_TREES)
def test_the_f32_plan_covers_every_output_once(f32_launches, size):
    """The tiles' patches cover the output (2h x 2w with up) once per N tile,
    image and K range, the N tiles Cout, the chunks Cin (both padded to
    multiples of 4); the persistent blocks' runs partition the tiles."""
    _covers_every_output_once(f32_launches[size])


def _covers_every_output_once(launches):
    for key, plan in _f32_plans(launches):
        kind, b, h, w, ci, co, up = key[:7]
        assert (plan["ho"], plan["wo"]) == ((2 * h, 2 * w) if up else (h, w)), key
        ph, pw = plan["patch"]
        tiles_x = -(-plan["wo"] // pw)
        patches, ntiles, nsplit = plan["tile_grid"]
        assert nsplit == b * plan["ksplit"], key
        assert plan["tiles"] == patches * ntiles * nsplit, key
        # the blocks' runs of tiles partition the tiles, in order
        nb = plan["blocks"]
        runs = [(i * plan["tiles"] // nb, (i + 1) * plan["tiles"] // nb) for i in range(nb)]
        assert nb == plan["grid"][0] == min(plan["tiles"], key[-1]), key
        assert runs[0][0] == 0 and runs[-1][1] == plan["tiles"], key
        assert all(r1[0] == r0[1] and r0[1] > r0[0] for r0, r1 in zip(runs, runs[1:])), key
        # every (output pixel, channel, image) in one tile of each K range
        count = np.zeros((b, plan["ksplit"], ntiles, plan["ho"], plan["wo"]), np.int32)
        for t in range(plan["tiles"]):
            patch, r = t % patches, t // patches
            split, r = r % plan["ksplit"], r // plan["ksplit"]
            img, nt = r % b, r // b
            y0, x0 = (patch // tiles_x) * ph, (patch % tiles_x) * pw
            assert y0 < plan["ho"] and x0 < plan["wo"], key
            count[img, split, nt, y0:y0 + ph, x0:x0 + pw] += 1
        assert (count == 1).all(), key
        assert plan["cin"] % 4 == 0 and 0 <= plan["cin"] - ci < 4, key
        assert plan["cout"] % 4 == 0 and 0 <= plan["cout"] - co < 4, key
        assert (ntiles - 1) * plan["bn"] < plan["cout"] <= ntiles * plan["bn"], key
        assert (plan["chunks"] - 1) * plan["bk"] < plan["cin"] <= plan["chunks"] * plan["bk"], key
        assert plan["resident"] == (plan["chunks"] == 1), key


@pytest.mark.parametrize("size,cut", HALO_SPLITS)
def test_the_f32_halo_plan_covers_every_output_once(size, cut):
    _covers_every_output_once(_split(_with_backward(_unet_convs(size)), cut))


@pytest.mark.parametrize("group", F32_GROUPS)
def test_every_k_chunk_lands_in_exactly_one_split_share(f32_launches, group):
    """The split ranges partition the chunks in order, none empty, and
    split K fills no more than the SMs."""
    for key, plan in _f32_plans(_f32_group(f32_launches, group)):
        ranges, chunks, ks = plan["split_ranges"], plan["chunks"], plan["ksplit"]
        assert len(ranges) == ks and 1 <= ks <= min(chunks, k3.F32_MAX_SPLIT), key
        owner = np.zeros(chunks, np.int32)
        for k0, k1 in ranges:
            assert k1 > k0, key
            owner[k0:k1] += 1
        assert (owner == 1).all() and [r[0] for r in ranges] == sorted(r[0] for r in ranges), key
        assert ranges[0][0] == 0 and ranges[-1][1] == chunks, key
        sms = key[-1]
        if ks > 1:
            assert plan["tiles"] <= sms, key
            assert "split_k" in plan["classes"] and plan["ws_floats"] == ks * key[1] * plan[
                "ho"] * plan["wo"] * plan["cout"], key
        else:
            assert plan["ws_floats"] == 0, key


def test_the_split_partials_are_summed_in_a_fixed_order():
    """The finish pass's order (range 0 first, each range's chunks in order)
    on the plan's ranges: bit-identical on every rerun, within f32 rounding
    of the unsplit sum, and the one order the kernel uses (summing the
    ranges in another order is not bit-identical on these inputs)."""
    rng = np.random.RandomState(0)
    plan = k3.f32_plan(1, 16, 16, 2048, 1024)
    assert plan["ksplit"] > 1
    chunk_sums = (rng.randn(plan["chunks"], 256) * 10 ** rng.uniform(-3, 3, (plan["chunks"], 1))
                  ).astype(np.float32)

    def finish(order):
        total = np.zeros(256, np.float32)
        for s in order:
            k0, k1 = plan["split_ranges"][s]
            part = np.zeros(256, np.float32)
            for c in range(k0, k1):
                part += chunk_sums[c]
            total += part
        return total

    fixed = range(plan["ksplit"])
    a, b = finish(fixed), finish(fixed)
    assert np.array_equal(a, b)
    np.testing.assert_allclose(a, chunk_sums.astype(np.float64).sum(0), rtol=1e-5, atol=1e-3)
    assert not np.array_equal(a, finish(reversed(fixed)))


@pytest.mark.parametrize("size", F32_TREES)
def test_the_f32_window_holds_every_tap(f32_launches, size):
    """The staged window of a patch at (y0, x0) starts at source row / col
    (y0 - 1, x0 - 1), with up (y0 / 2 - 1, x0 / 2 - 1); it holds exactly the
    rows and columns the patch's taps read, and the kernel's fragment
    address (window row (py + dy + 1) / 2 with up) names the right one."""
    for key, plan in _f32_plans(f32_launches[size]):
        up = key[6]
        rh, rw = plan["window"]
        ph, pw = plan["patch"]
        assert (rh, rw) == ((ph // 2 + 2, pw // 2 + 2) if up else (ph + 2, pw + 2)), key
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
    """The rings (at least two windows, at least three weight slabs) fit a
    block's 227 KB beside the static reserve; K-dx f32 writes one dA/dB
    partial row per output patch."""
    for key, plan in _f32_plans(f32_launches[size]):
        assert plan["smem_bytes"] == _f32_smem(plan) <= k3.SMEM_MAX - k3.F32_STATIC, key
        assert plan["win_stages"] >= 2 and 3 <= plan["slab_stages"] <= k3.F32_MAX_SS, key
        assert plan["threads"] == k3.F32_THREADS == 32 * 12, key
        if key[0] == "dx":
            assert plan["partial_rows"] == plan["tile_grid"][0], key
        else:
            assert plan["partial_rows"] is None, key


@pytest.mark.parametrize("group", F32_GROUPS)
def test_each_f32_shape_class_is_chosen_where_the_rule_says(f32_launches, group):
    """narrow K where Cin <= 16 (one k8 step a chunk up to 8 channels, two up
    to 16), narrow N where
    Cout <= 8 (bn 8; else 64), split K where the tiles do not fill the SMs, a short
    patch (4 x 32, 2 x 64) on outputs under 8 rows, up and halo by mode."""
    seen = set()
    for key, plan in _f32_plans(_f32_group(f32_launches, group)):
        kind, b, h, w, ci, co, up, pro, halo, sms = key
        ho = 2 * h if up else h
        tiles = plan["tile_grid"][0] * plan["tile_grid"][1] * b
        want = {name for name, on in (
            ("narrow_k", plan["cin"] <= 16), ("narrow_n", plan["cout"] <= 8),
            ("split_k", tiles < sms and min(sms // tiles, plan["chunks"]) > 1),
            ("short_patch", ho < 8), ("up", up), ("halo", halo)) if on}
        assert plan["classes"] == want, key
        assert plan["k8_steps"] == (1 if plan["cin"] <= 8 else 2 if plan["cin"] <= 16 else 4), key
        assert plan["bn"] == (8 if "narrow_n" in want else 64), key
        if plan["resident"]:  # the one chunk's nine weight slabs stay in shared memory
            assert plan["slab_stages"] >= 9, key
        assert plan["patch"] == ((8, 16) if ho >= 8 else (4, 32) if ho >= 4 else (2, 64)), key
        seen |= want
    expect = {"tree64": {"narrow_k", "narrow_n", "split_k", "up"},
              "tree128": {"narrow_k", "narrow_n", "split_k", "up"},
              "tree256": {"narrow_k", "narrow_n", "split_k", "up"},
              "tree512": {"narrow_k", "narrow_n", "split_k", "up"}}
    assert seen >= expect.get(group, {"halo", "split_k", "short_patch", "narrow_k"}), group


@pytest.mark.parametrize("size,cut", HALO_SPLITS)
def test_the_f32_halo_plan_takes_rows_minus_1_and_h_from_the_neighbours(f32_launches, size,
                                                                        cut):
    """f32_plan(halo=True) on every K-halo launch of the split tree: window
    rows -1 and h come from etop / ebot, rows inside the shard from x, and
    every tap of a written output lands on one of those, inside the window;
    the 8^2 level's 4- and 2-row shards take a patch as short as they are."""
    halo = _split(f32_launches[size], cut)
    assert min(key[2] for key in halo) == 8 // cut < 8  # the 8^2 level's shards
    for key in halo:
        _, b, h, w, ci, co, up, _, is_halo = key
        assert is_halo and not up, key
        plan = k3.f32_plan(b, h, w, ci, co, halo=True)
        assert plan["halo_rows"] == {-1: "etop", h: "ebot"}, key
        ph, pw = plan["patch"]
        assert plan["window"] == (ph + 2, pw + 2) and ph <= max(h, 2), key
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


def _tf32_rna_numpy(v):
    """numpy's TF32 rounding (to nearest, ties away from zero) of f32 ``v``."""
    bits = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("cin,cout", [(4, 8), (8, 256), (12, 20), (64, 100), (256, 4), (36, 20)])
def test_the_weight_split_plain_version_matches_numpy_tf32_rounding(cin, cout):
    """split_weights_plain against numpy: hi the TF32 rounding of w, lo that
    of w - hi, K-major rows (one per output channel, zero rows past cout);
    up to 8 input channels a row of 8 in natural order, else position
    8s + t + 4h of each 16-channel group holding channel 4t + 2s + h (zero
    past cin); hi + lo within 2^-21 of w."""
    import torch

    rng = np.random.RandomState(cin + cout)
    w = (rng.randn(3, 3, cin, cout) * 10.0 ** rng.uniform(-4, 2, (3, 3, cin, cout))).astype(
        np.float32)
    got = k3.split_weights_plain(torch.from_numpy(w)).numpy()
    cout8, cink = -(-cout // 8) * 8, 8 if cin <= 8 else -(-cin // 16) * 16
    assert got.shape == (2, 9, cout8, cink)
    wk = np.zeros((9, cout8, cink), np.float32)
    for pos in range(cink):
        g, r = divmod(pos, 16)
        s, t, h = r // 8, r % 4, (r // 4) % 2
        c = pos if cin <= 8 else 16 * g + 4 * t + 2 * s + h
        if c < cin:
            wk[:, :cout, pos] = w.reshape(9, cin, cout)[:, c, :]
    hi = _tf32_rna_numpy(wk)
    lo = _tf32_rna_numpy(wk - hi)
    assert np.array_equal(got[0], hi) and np.array_equal(got[1], lo)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_allclose(hi.astype(np.float64) + lo, wk, rtol=2.0 ** -21, atol=0)
