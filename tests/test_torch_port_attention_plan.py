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
F32_KERNELS = ("fwd", "bwd_dq", "bwd_dkdv")


def _f32_smem(d, own, stage_floats, stages, vec_floats=0):
    """Bytes: ``own`` 64-row tiles of d floats, ``stages`` ring stages of
    ``stage_floats`` floats, ``vec_floats`` more, and 1 KB of slack to align
    the 128B-swizzled TMA boxes."""
    return 4 * (own * 64 * d + stages * stage_floats + vec_floats) + 1024


@pytest.mark.parametrize("d", kattn.HEAD_DIMS)
@pytest.mark.parametrize("t", F32_TS)
def test_the_f32_plan_fits_one_block(d, t):
    plan = kattn.f32_attn_plan(2, 4, t, d)
    st, sg = plan["stream"], plan["stages"]
    assert plan["smem"] == {
        "fwd": _f32_smem(d, 1, st["fwd"] * (d + 64), sg["fwd"]),  # K and V's 64 columns
        "bwd_dq": _f32_smem(d, 2, 2 * st["bwd_dq"] * d, sg["bwd_dq"]),
        "bwd_dkdv": _f32_smem(d, 2, 2 * st["bwd_dkdv"] * d, sg["bwd_dkdv"],
                              2 * st["bwd_dkdv"] * sg["bwd_dkdv"])}  # + each stage's lse, D
    for kernel, smem in plan["smem"].items():
        # the mbarriers (one per stage and direction, one for the own tiles)
        # are static shared memory beside the dynamic part
        assert 0 < smem + 8 * (2 * sg[kernel] + 1) <= kattn.SMEM_MAX, (d, t, kernel)
    assert plan["body"] == kattn.F32_BODY == "mma.sync-3xtf32"
    assert plan["bwd_launches"] == 2 and plan["mmas_per_product"] == 3
    assert all(3 <= s <= 4 for s in sg.values())  # a ring of more than two stages


@pytest.mark.parametrize("d", kattn.HEAD_DIMS)
@pytest.mark.parametrize("t", F32_TS)
def test_the_f32_tiles_cover_t_and_split_over_the_threads(d, t):
    """64-row blocks cover T, and each kernel's streamed tiles cover T; a
    tile is whole mma.sync k8 / n8 steps and whole 8-row swizzle periods; the
    threads are a producer (a warpgroup with two halves, else a warp) and
    four 16-row consumer warps a half."""
    plan = kattn.f32_attn_plan(2, 4, t, d)
    assert (plan["tiles"] - 1) * plan["q_tile"] < t <= plan["tiles"] * plan["q_tile"]
    assert plan["q_tile"] == 16 * plan["warps"] == 64
    for kernel in F32_KERNELS:
        tile, n = plan["stream"][kernel], plan["streamed_tiles"][kernel]
        assert tile % 8 == 0 and 0 < tile <= plan["q_tile"] and 64 % tile == 0, kernel
        assert (n - 1) * tile < t <= n * tile, kernel
        halves = plan["halves"][kernel]
        producer = 128 if halves == 2 else 32
        assert plan["threads"][kernel] == producer + 128 * halves, kernel
        assert plan["box"][kernel] == (kattn.F32_BOX, tile, 1)
    assert d % kattn.F32_COLS == 0 and kattn.F32_BOX * 4 == 128


@pytest.mark.parametrize("group", GROUPS)
def test_the_f32_plan_covers_the_unet_attentions(shapes, group):
    for b, h, t, d in shapes[group]:
        plan = kattn.f32_attn_plan(b, h, t, d)
        assert max(plan["smem"].values()) <= kattn.SMEM_MAX, (b, h, t, d)
        assert plan["grid"]["fwd"] == (-(-t // 64), b * h, d // 64)


def test_the_f32_plan_streams_16_rows_in_the_backward_at_d_256():
    """At d = 256 the dQ kernel's Q and dO (128 KB) leave room for three
    stages of 16-row K/V tiles, not of 32-row ones (nor for four stages); the
    dK/dV kernel streams the same tiles."""
    plan = kattn.f32_attn_plan(1, 4, 64, 256)
    assert plan["stream"] == {"fwd": 32, "bwd_dq": 16, "bwd_dkdv": 16}
    assert plan["stages"] == {"fwd": 4, "bwd_dq": 3, "bwd_dkdv": 3}
    assert _f32_smem(256, 2, 2 * 32 * 256, 3) > kattn.SMEM_MAX
    assert _f32_smem(256, 2, 2 * 16 * 256, 4) > kattn.SMEM_MAX
    with pytest.raises(ValueError, match="head dim 32"):
        kattn.f32_attn_plan(1, 2, 16, 32)


@pytest.mark.parametrize("group", GROUPS)
def test_every_f32_output_column_has_one_owner(shapes, group):
    """The column split: for each (row tile, batch*head) the blocks along
    grid z own 64-column shares that cover the head's d columns exactly once
    (no two blocks write one element, so no atomics are needed)."""
    for b, h, t, d in shapes[group]:
        plan = kattn.f32_attn_plan(b, h, t, d)
        owners = [0] * d
        for lo, hi in plan["shares"]:
            assert hi - lo == plan["cols"] == kattn.F32_COLS
            for c in range(lo, hi):
                owners[c] += 1
        assert owners == [1] * d, (b, h, t, d)
        for kernel in F32_KERNELS:
            assert plan["grid"][kernel][2] == len(plan["shares"]), kernel


@pytest.mark.parametrize("d", kattn.HEAD_DIMS)
@pytest.mark.parametrize("t", F32_TS)
def test_the_f32_halves_see_their_own_stages(d, t):
    """With two halves of consumers, streamed tile i goes to half i % 2 and
    sits in stage i % stages: each stage serves one half only (an even ring),
    and every tile has one consumer half."""
    plan = kattn.f32_attn_plan(1, 4, t, d)
    for kernel in F32_KERNELS:
        halves, stages = plan["halves"][kernel], plan["stages"][kernel]
        assert halves == (2 if stages % 2 == 0 else 1), kernel
        served = {}
        for i in range(plan["streamed_tiles"][kernel]):
            served.setdefault(i % stages, set()).add(i % halves)
        assert all(len(v) == 1 for v in served.values()), kernel


@pytest.mark.parametrize("kernel", F32_KERNELS)
def test_the_f32_products_run_on_the_tensor_cores(kernel):
    """Every product is a TF32 tensor-core MMA (three of them in the 3xTF32
    split); a wgmma operand staged in shared memory would have to be K-major
    (TF32 has no transpose), and mma.sync takes either layout. The products
    over tokens take A from the registers of the product before."""
    products = kattn.f32_attn_plan(1, 4, 256, 128)["products"][kernel]
    assert products
    for name, (instr, a, b) in products.items():
        assert instr.startswith(("mma.sync.m16n8k8.tf32", "wgmma.m64")), name
        assert a in ("k-major", "mn-major", "registers") and b in ("k-major", "mn-major"), name
        if instr.startswith("wgmma"):
            assert a in ("k-major", "registers") and b == "k-major", name
        over_tokens = "+=" in name
        assert (a == "registers") == over_tokens and (b == "mn-major") == over_tokens, name


def test_chip_smoke_reads_ptxas_for_both_attention_namespaces():
    """chip_smoke.py phase 2 prints registers and spills of every attention
    kernel, bf16 (``cgd::attn``) and f32 (``cgd::attn32``), read from the
    mangled names by their lengths; other kernels are left out."""
    import chip_smoke

    def entry(mangled, regs, spill):
        return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {mangled}\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, 80 bytes smem\n")

    log = (entry("_ZN3cgd6attn3224attn_bwd_dkdv_f32_kernelILi128EEEv14CUtensorMap_stS2_PKfS4_Pfii",
                 168, 492)
           + entry("_ZN3cgd4attn15attn_fwd_kernelILi64EEEv14CUtensorMap_stP13__nv_bfloat16Pfiiif",
                   168, 0)
           + entry("_ZN3cgd7f32conv18conv3x3_f32_kernelILb0ELb0ELb0ELi0EEEvNS0_6ParamsE", 128, 0))
    assert chip_smoke._attn_ptxas(log) == [
        "attn32::attn_bwd_dkdv_f32_kernel<128>: 168 registers, spill stores / loads 492 / 492 bytes",
        "attn::attn_fwd_kernel<64>: 168 registers, spill stores / loads 0 / 0 bytes"]
