"""The attention kernels' launch plan (``kernels.attention.attn_plan``) on the CPU.

The plan is the geometry that the wrapper and the CUDA kernels must agree on
(the body, the 64-row tiles, each ring's stages, the split of the streamed
tiles or of D over the two consumer warpgroups, the grids, the shared
memory, the TMA box). These tests hold it, for every attention of the
class-conditional UNets at 64, 128, 256 and 512 px (the 128px model is the
one with head dims 128, 192 and 256) and for the ragged shapes of the card
tests, to what the kernels need: tiles that cover T, a split that gives each
consumer a tile, column shares on 64-channel box boundaries, shared memory
within a block's 227 KB, TMA boxes and strides the hardware takes. The
shapes come from the full-size UNets run on the ``meta`` device with the
attention calls recorded.
"""

import pytest
import torch

from cgd_tpu_torch.kernels import attention as kattn
from cgd_tpu_torch.kernels import conv3x3 as k3

SIZES = (64, 128, 256, 512)
_STATIC = 256  # the mbarriers, static shared memory


def _unet_attentions(size):
    """(b, heads, T, d) of every attention of the full-size class-conditional
    UNet's forward at ``size`` px."""
    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.registry import DIFFUSION_LOOKUP

    rec = []

    def attn(qkv, n):
        b, t, c3 = qkv.shape
        rec.append((b, n, t, c3 // 3 // n))
        return qkv[..., : c3 // 3]

    def conv(x, w, bias, A=None, B=None, skip=None, up=False, etop=None, ebot=None):
        b, h, wd, _ = x.shape
        s = 2 if up else 1
        return torch.empty(b, s * h, s * wd, w.shape[-1], dtype=x.dtype, device=x.device)

    saved = k3.conv3x3_fwd, kattn.qkv_attention
    k3.conv3x3_fwd, kattn.qkv_attention = conv, attn
    try:
        cfg = UNetConfig.from_flags(DIFFUSION_LOOKUP["cond"][size]["model_flags"])
        unet = UNet(cfg, device="meta")
        x = torch.empty(1, size, size, 3, device="meta")
        unet(x, torch.zeros(1, device="meta"), torch.zeros(1, dtype=torch.long, device="meta"),
             compute_dtype=torch.bfloat16)
    finally:
        k3.conv3x3_fwd, kattn.qkv_attention = saved
    return rec


# the card tests' shapes (tests/test_torch_port_cuda.py ATTN): ragged T,
# batches, T across the split (65) and a one-tile T (45)
_RAGGED = [(1, 8, 1024, 64), (1, 16, 64, 64), (2, 3, 100, 64), (1, 4, 256, 128), (1, 2, 77, 192),
           (2, 2, 45, 256), (2, 8, 1000, 64), (1, 4, 65, 64), (2, 2, 129, 128), (1, 4, 256, 192),
           (1, 4, 64, 256), (2, 2, 300, 192), (1, 2, 200, 256)]


@pytest.fixture(scope="module")
def shapes():
    found = {size: _unet_attentions(size) for size in SIZES}
    found["ragged"] = _RAGGED
    return found


GROUPS = [*SIZES, "ragged"]


def test_the_unet_attentions_are_found(shapes):
    for size in (256, 512):  # 32^2, 16^2 and 8^2 at d = 64: 5 + 5 + 6 blocks
        assert sorted(set(shapes[size])) == [(1, 8, 1024, 64), (1, 16, 64, 64), (1, 16, 256, 64)]
        assert len(shapes[size]) == 16
    assert {d for _, _, _, d in shapes[128]} == {128, 192, 256}


@pytest.mark.parametrize("group", GROUPS)
def test_the_tiles_cover_t(shapes, group):
    for b, h, t, d in shapes[group]:
        plan = kattn.attn_plan(b, h, t, d)
        for tile in (plan["q_tile"], plan["kv_tile"]):
            assert (plan["tiles"] - 1) * tile < t <= plan["tiles"] * tile, (b, h, t, d)
        for kernel in ("fwd", "bwd_dq", "bwd_dkdv"):
            assert plan["grid"][kernel] == (plan["tiles"], b * h), (b, h, t, d, kernel)


@pytest.mark.parametrize("group", GROUPS)
def test_every_consumer_gets_a_tile(shapes, group):
    """Tile i of the loop goes to consumer warpgroup i % split: every
    consumer that the split counts sees at least one tile, or the plan sets
    the split to 1."""
    for b, h, t, d in shapes[group]:
        plan = kattn.attn_plan(b, h, t, d)
        split = plan["split"]
        assert split >= 1
        assert all(any(i % split == c for i in range(plan["tiles"])) for c in range(split))
        assert split == (2 if plan["tiles"] >= 2 else 1), (b, h, t, d)
        for stages in plan["stages"].values():  # stage s always serves consumer s % 2
            assert stages % 2 == 0 and stages >= split


@pytest.mark.parametrize("group", GROUPS)
def test_shared_memory_fits_one_block(shapes, group):
    for b, h, t, d in shapes[group]:
        plan = kattn.attn_plan(b, h, t, d)
        for kernel, smem in plan["smem"].items():
            assert 0 < smem <= kattn.SMEM_MAX - _STATIC, (b, h, t, d, kernel)
        tile = plan["q_tile"] * d * 2  # the ring and the block's own tiles at least
        assert plan["smem"]["fwd"] >= (1 + 2 * plan["stages"]["fwd"]) * tile
        assert plan["smem"]["bwd_dq"] >= (3 + 2 * plan["stages"]["bwd_dq"]) * tile
        assert plan["smem"]["bwd_dkdv"] >= (2 + 2 * plan["stages"]["bwd_dkdv"]) * tile


@pytest.mark.parametrize("group", GROUPS)
def test_tma_boxes_and_strides(shapes, group):
    for b, h, t, d in shapes[group]:
        plan = kattn.attn_plan(b, h, t, d)
        inner, rows, depth = plan["box"]
        assert inner * 2 == 128 and d % inner == 0  # one 128B swizzle row; whole boxes per head
        assert rows == plan["q_tile"] == plan["kv_tile"] and depth == 1
        assert all(1 <= x <= 256 for x in plan["box"])
        for width in (3 * h * d, h * d):  # qkv rows, out / dout rows
            assert (width * 2) % 16 == 0 and (t * width * 2) % 16 == 0


@pytest.mark.parametrize("group", GROUPS)
def test_the_column_shares_are_whole_boxes(shapes, group):
    """Above d = 128 the consumers split D: each kernel's shares cover the
    head's columns once, start and end on 64-channel boxes (a swizzled
    MN-major B operand starts at a box), and give each consumer at most 128
    columns a pass (the accumulators that fit its registers)."""
    for b, h, t, d in shapes[group]:
        plan = kattn.attn_plan(b, h, t, d)
        if d <= 128:
            assert plan["cols"] is None
            continue
        for kernel, per_consumer in plan["cols"].items():
            assert len(per_consumer) == 2, kernel
            ranges = sorted(r for passes in per_consumer for r in passes)
            assert ranges[0][0] == 0 and ranges[-1][1] == d, (d, kernel)
            assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:])), (d, kernel)
            for lo, hi in ranges:
                assert lo % kattn.BOX == 0 and hi % kattn.BOX == 0 and 0 < hi - lo <= 128
        assert all(hi - lo == kattn.BOX for passes in plan["cols"]["bwd_dkdv"] for lo, hi in passes)


@pytest.mark.parametrize("d,body,launches", [(64, "wgmma", 2), (128, "wgmma", 2),
                                             (192, "wgmma", 2), (256, "wgmma", 2)])
def test_the_body_follows_the_head_dim(d, body, launches):
    plan = kattn.attn_plan(1, 4, 256, d)
    assert plan["body"] == body and plan["bwd_launches"] == launches
    assert d in kattn.HEAD_DIMS
    assert plan["stages"] == {"fwd": kattn.FWD_STAGES[d], "bwd_dq": kattn.BWD_STAGES[d],
                              "bwd_dkdv": kattn.BWD_STAGES[d]}


def test_one_tile_runs_on_one_consumer():
    assert kattn.attn_plan(1, 16, 64, 64)["split"] == 1
    assert kattn.attn_plan(1, 16, 65, 64)["split"] == 2


def test_the_plan_is_made_once_per_shape():
    assert kattn.attn_plan(1, 8, 1024, 64) is kattn.attn_plan(1, 8, 1024, 64)


def test_an_unsupported_head_dim_raises():
    with pytest.raises(ValueError, match="head dim 32"):
        kattn.attn_plan(1, 2, 16, 32)


# K-attn-f / K-attn-b f32 (csrc/attn_f32.cu): the plan at every head dim, at
# T = 64, 256, 1024 and ragged T, and at every attention of the UNets
F32_TS = (64, 256, 1024, 77, 300)


def _f32_smem(d, own, streamed, tile, scores):
    """Bytes: ``own`` tiles of the block's 64 rows, two stages of
    ``streamed`` tiles of ``tile`` rows, ``scores`` [64][tile + 4] arrays;
    every row d + 4 floats."""
    row = d + 4
    return 4 * (own * 64 * row + 2 * streamed * tile * row + scores * 64 * (tile + 4))


@pytest.mark.parametrize("d", kattn.HEAD_DIMS)
@pytest.mark.parametrize("t", F32_TS)
def test_the_f32_plan_fits_one_block(d, t):
    plan = kattn.f32_attn_plan(2, 4, t, d)
    stream = plan["stream"]
    assert plan["smem"] == {
        "fwd": _f32_smem(d, 1, 2, stream["fwd"], 1),
        "bwd_dq": _f32_smem(d, 2, 2, stream["bwd_dq"], 1),
        "bwd_dkdv": _f32_smem(d, 2, 2, stream["bwd_dkdv"], 2)}
    for kernel, smem in plan["smem"].items():
        assert 0 < smem <= kattn.SMEM_MAX, (d, t, kernel)
    assert plan["body"] == "f32-fma" and plan["bwd_launches"] == 2 and plan["stages"] == 2


@pytest.mark.parametrize("d", kattn.HEAD_DIMS)
@pytest.mark.parametrize("t", F32_TS)
def test_the_f32_tiles_cover_t_and_split_over_the_threads(d, t):
    """64-row blocks cover T; each streamed tile splits evenly over a row's
    threads (256 threads, 4 a row, each every fourth key); a thread's column
    share is whole 16-byte vectors."""
    plan = kattn.f32_attn_plan(2, 4, t, d)
    assert (plan["tiles"] - 1) * plan["q_tile"] < t <= plan["tiles"] * plan["q_tile"]
    assert plan["threads"] == 4 * plan["q_tile"] == 256
    for kernel, tile in plan["stream"].items():
        assert tile % 4 == 0 and 0 < tile <= plan["q_tile"], kernel
        assert plan["grid"][kernel] == (plan["tiles"], 8), kernel
    assert d % (4 * 4) == 0


@pytest.mark.parametrize("group", GROUPS)
def test_the_f32_plan_covers_the_unet_attentions(shapes, group):
    for b, h, t, d in shapes[group]:
        plan = kattn.f32_attn_plan(b, h, t, d)
        assert max(plan["smem"].values()) <= kattn.SMEM_MAX, (b, h, t, d)
        assert plan["grid"]["fwd"] == (-(-t // 64), b * h)


def test_the_f32_plan_streams_16_rows_in_the_backward_at_d_256():
    """At d = 256 two stages of 32-row K/V tiles beside Q and dO (or K and
    V) take more than a block may: the backward streams 16-row tiles."""
    assert kattn.f32_attn_plan(1, 4, 64, 256)["stream"] == {"fwd": 32, "bwd_dq": 16,
                                                            "bwd_dkdv": 16}
    assert _f32_smem(256, 2, 2, 32, 1) > kattn.SMEM_MAX
    with pytest.raises(ValueError, match="head dim 32"):
        kattn.f32_attn_plan(1, 2, 16, 32)
