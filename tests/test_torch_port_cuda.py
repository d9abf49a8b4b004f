"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a card every test skips (the kernels have no CPU
mode). This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Bound: max |err| <= 1% of the reference's max |value| in bf16 (the order of
bf16 rounding; the two round at different points).
"""

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch.kernels import attention as kattn  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402
from cgd_tpu_torch.kernels import conv_spmd  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close(a, b):
    assert (a.float() - b.float()).abs().max() <= TOL * b.float().abs().max()


def _inputs(dev, b, h, ci, co, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)

    return dict(
        x=rn(b, h, h, ci), w=rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), bias=rn(co, scale=0.1),
        A=1.0 + 0.2 * torch.randn(b, ci, generator=gen, device=dev),
        B=0.2 * torch.randn(b, ci, generator=gen, device=dev),
        skip=rn(b, h, h, co), up_skip=rn(b, 2 * h, 2 * h, co), g=rn(b, h, h, co),
    )


# (batch, H, Cin, Cout): ragged M and N tiles, skinny channels, split-K sizes
SHAPES = [(2, 24, 64, 96), (1, 16, 3, 256), (1, 32, 256, 6), (1, 8, 1024, 512)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["plain", "prologue", "skip", "up"])
def test_kfwd_matches_plain(dev, shape, variant):
    d = _inputs(dev, *shape)
    A, B = (None, None) if variant == "plain" else (d["A"], d["B"])
    skip = d["skip"] if variant == "skip" else None
    up = variant == "up"
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(d["x"], d["w"], d["bias"], A, B, skip, up)
    assert k3.LAUNCHES["conv3x3_fwd"] == 1
    _close(out, k3.conv3x3_fwd_plain(d["x"], d["w"], d["bias"], A, B, skip, up))


@pytest.mark.parametrize("shape", SHAPES)
def test_kdx_matches_plain_and_is_deterministic(dev, shape):
    d = _inputs(dev, *shape)
    wt = k3._flip_t(d["w"])
    got = k3.conv3x3_dx(d["g"], wt, d["x"], d["A"], d["B"])
    again = k3.conv3x3_dx(d["g"], wt, d["x"], d["A"], d["B"])
    for a, b, c in zip(got, k3.conv3x3_dx_plain(d["g"], wt, d["x"], d["A"], d["B"]), again):
        _close(a, b)
        assert torch.equal(a, c)


def test_autograd_functions_use_the_kernels(dev):
    d = _inputs(dev, 1, 16, 64, 64)
    x = d["x"].clone().requires_grad_(True)
    A = d["A"].clone().requires_grad_(True)
    k3.reset_launch_counts()
    out = k3.conv3x3_gn_silu_add(x, A, d["B"], d["w"], d["bias"], d["skip"])
    out.float().sum().backward()
    assert k3.LAUNCHES == {"conv3x3_fwd": 1, "conv3x3_fwd_halo": 0, "conv3x3_dx": 1,
                           "conv3x3_dx_wtiled": 0, "conv3x3_fwd_f32": 0}
    assert x.grad.dtype == torch.bfloat16 and A.grad.dtype == torch.float32


def test_f32_raises_with_the_dtype_named(dev):
    """f32 x with bf16 weights: the f32 kernel names the dtype it takes."""
    d = _inputs(dev, 1, 8, 32, 32)
    with pytest.raises(TypeError, match="float32"):
        k3.conv3x3_fwd(d["x"].float(), d["w"], d["bias"])


# K-fwd f32 (csrc/conv3x3_f32.cu), held to its plain version with cuDNN in
# full f32 at the conv family's bound, 1% of the reference's max (3xTF32
# keeps about f32's precision; the bound is the family's).
# (batch, H, W, Cin, Cout): the VGG16's first conv and its 3-channel input
# gradient, ragged patches and N tiles, a Cin that is no multiple of 32
F32_SHAPES = [(1, 32, 32, 3, 64), (1, 32, 32, 64, 3), (2, 20, 36, 36, 20), (1, 16, 16, 512, 512),
              (2, 9, 17, 8, 100), (1, 64, 64, 64, 64)]


def _f32_inputs(dev, b, h, w, ci, co, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(b, h, w, ci, generator=gen, device=dev),
            torch.randn(3, 3, ci, co, generator=gen, device=dev) * (9 * ci) ** -0.5,
            torch.randn(co, generator=gen, device=dev) * 0.1)


@pytest.fixture
def full_f32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("shape", F32_SHAPES)
def test_kfwd_f32_matches_plain(dev, full_f32, shape):
    x, w, bias = _f32_inputs(dev, *shape)
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(x, w, bias)
    assert k3.LAUNCHES["conv3x3_fwd_f32"] == 1 and k3.LAUNCHES["conv3x3_fwd"] == 0
    assert out.dtype == torch.float32 and out.shape == shape[:3] + (shape[4],)
    _close(out, k3.conv3x3_fwd_plain(x, w, bias))


def test_kfwd_f32_input_gradient_runs_on_the_f32_kernel(dev, full_f32):
    x, w, bias = _f32_inputs(dev, 1, 24, 24, 3, 64, seed=1)
    g = torch.randn(1, 24, 24, 64, device=dev)
    xk = x.clone().requires_grad_(True)
    k3.reset_launch_counts()
    (dk,) = torch.autograd.grad(k3.conv3x3(xk, w, bias), xk, g)
    assert k3.LAUNCHES["conv3x3_fwd_f32"] == 2  # forward, and the flipped conv for dx
    xp = x.clone().requires_grad_(True)
    (dp,) = torch.autograd.grad(k3.conv3x3_fwd_plain(xp, w, bias), xp, g)
    _close(dk, dp)


@pytest.mark.parametrize("fusion", ["prologue", "skip", "up", "halo"])
def test_kfwd_f32_refuses_the_fused_modes(dev, fusion):
    x, w, bias = _f32_inputs(dev, 1, 8, 8, 32, 32)
    A = B = skip = etop = ebot = None
    if fusion == "prologue":
        A, B = torch.ones(1, 32, device=dev), torch.zeros(1, 32, device=dev)
    elif fusion == "skip":
        skip = torch.zeros(1, 8, 8, 32, device=dev)
    elif fusion == "halo":
        etop = ebot = torch.zeros(1, 1, 8, 32, device=dev)
    with pytest.raises(ValueError, match="plain conv only"):
        k3.conv3x3_fwd(x, w, bias, A, B, skip, fusion == "up", etop, ebot)


def test_the_f32_kernel_sizes_shared_memory_as_the_plan(dev):
    from cgd_tpu_torch.kernels import _build

    assert _build.library().cgd_conv3x3_f32_smem_bytes() == k3.f32_plan(1, 16, 16, 64, 64)[
        "smem_bytes"]


def test_lpips_on_the_card_matches_the_plain_routing(dev, full_f32):
    """The whole VGG16 LPIPS distance and its input gradient at 64^2, the
    convs on K-fwd f32 against cuDNN in f32: relative L2 <= 1e-2."""
    from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS, lpips_distance
    from cgd_tpu_torch.ops.nn import kernel_routing

    model = VGGLPIPS(device=dev).init_weights(torch.Generator(dev).manual_seed(0))
    gen = torch.Generator(dev).manual_seed(1)
    x, y = (torch.rand(1, 64, 64, 3, generator=gen, device=dev) * 2 - 1 for _ in range(2))

    def run():
        x_ = x.clone().requires_grad_(True)
        d = lpips_distance(model, x_, y)
        return d.detach(), torch.autograd.grad(d.sum(), x_)[0]

    k3.reset_launch_counts()
    got = run()
    assert k3.LAUNCHES["conv3x3_fwd_f32"] == 39
    with kernel_routing("plain"):
        want = run()
    for a, b in zip(got, want):
        assert ((a - b).norm() / b.norm()).item() <= 1e-2


def _rn(dev, *shape, scale=1.0, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


# (batch, H, W, Cin, Cout): the 512^2 width, ragged 8 x 16 tiles, skinny channels
WTILED = [(1, 64, 512, 128, 128), (1, 24, 40, 64, 96), (2, 9, 33, 32, 8)]


@pytest.mark.parametrize("shape", WTILED)
def test_kdx_wtiled_matches_plain_and_is_deterministic(dev, shape):
    b, h, w, ci, co = shape
    x, g = _rn(dev, b, h, w, ci, seed=1), _rn(dev, b, h, w, co, seed=2)
    wt = k3._flip_t(_rn(dev, 3, 3, ci, co, scale=(9 * ci) ** -0.5, seed=3))
    A = 1.0 + 0.2 * _rn(dev, b, ci, seed=4).float()
    B = 0.2 * _rn(dev, b, ci, seed=5).float()
    k3.reset_launch_counts()
    got = k3.conv3x3_dx(g, wt, x, A, B, wtiled=True)
    again = k3.conv3x3_dx(g, wt, x, A, B, wtiled=True)
    assert k3.LAUNCHES == {"conv3x3_fwd": 0, "conv3x3_fwd_halo": 0, "conv3x3_dx": 0,
                           "conv3x3_dx_wtiled": 2, "conv3x3_fwd_f32": 0}
    for a, ref, c in zip(got, k3.conv3x3_dx_plain(g, wt, x, A, B), again):
        _close(a, ref)
        assert torch.equal(a, c)


def test_kdx_takes_the_wtiled_mode_at_512_wide_images(dev):
    d = {k: v[:, :64] if v.dim() == 4 else v for k, v in _inputs(dev, 1, 512, 64, 64).items()}
    k3.reset_launch_counts()
    k3.conv3x3_dx(d["g"], k3._flip_t(d["w"]), d["x"], d["A"], d["B"])
    assert k3.LAUNCHES["conv3x3_dx_wtiled"] == 1 and k3.LAUNCHES["conv3x3_dx"] == 0


# (batch, heads, T, head dim): the UNet's T = 1024 / 64 at d = 64, ragged T,
# the other head dims (the 128px model, and its own 16^2 / 8^2 shapes), T
# across the two consumers' split and the batch boundary (a tile past row T
# of one image must read zeros, not the next image's rows), and rings that
# wrap at d = 192 / 256 (two stages, more tiles)
ATTN = [(1, 8, 1024, 64), (1, 16, 64, 64), (2, 3, 100, 64), (1, 4, 256, 128), (1, 2, 77, 192),
        (2, 2, 45, 256), (2, 8, 1000, 64), (1, 4, 65, 64), (2, 2, 129, 128), (1, 4, 256, 192),
        (1, 4, 64, 256), (2, 2, 300, 192), (1, 2, 200, 256)]


@pytest.mark.parametrize("b,h,t,d", ATTN)
def test_attention_kernels_match_plain_and_backward_is_deterministic(dev, b, h, t, d):
    qkv, g = _rn(dev, b, t, 3 * h * d, seed=6), _rn(dev, b, t, h * d, seed=7)
    kattn.reset_launch_counts()
    out, lse = kattn.attention_fwd(qkv, h)
    q, k, v = kattn.split_heads(qkv, h)
    _close(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), b))
    dqkv = kattn.attention_bwd(qkv, out, lse, g, h)
    assert torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, h))
    refs = kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g, h))
    for got, ref in zip(dqkv.chunk(3, dim=-1), refs):
        _close(got, kattn.merge_heads(ref, b))
    assert kattn.LAUNCHES == {"attn_fwd": 1, "attn_bwd": 2}
    assert kattn.LAUNCHES_BY_D[d] == kattn.LAUNCHES
    assert all(sum(n.values()) == 0 for e, n in kattn.LAUNCHES_BY_D.items() if e != d)


@pytest.mark.parametrize("b,h,t,d", [(1, 8, 1024, 64), (2, 3, 100, 64), (2, 2, 129, 128),
                                     (1, 2, 77, 192), (2, 2, 45, 256)])
def test_attention_lse_is_the_logsumexp_of_the_logits(dev, b, h, t, d):
    """The forward's lse [B*H, T] (natural log) against torch.logsumexp of
    the plain f32 logits of the same bf16 q, k (atol 1e-3 on values of
    ~log(T): the same f32 statistics, summed in another order, with exp2's
    few-ulp approximation)."""
    qkv = _rn(dev, b, t, 3 * h * d, seed=9)
    _, lse = kattn.attention_fwd(qkv, h)
    q, k, _ = kattn.split_heads(qkv, h)
    logits = (q.float() @ k.float().transpose(-1, -2)) / d ** 0.5
    assert lse.shape == (b * h, t) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-3, rtol=0)


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("d,body,launches", [(64, "attn::", 2), (128, "attn::", 2),
                                             (192, "attn::", 2), (256, "attn::", 2)])
def test_attention_backward_launches_by_head_dim(dev, d, body, launches):
    """One wrapper call of K-attn-b counts one launch; on the card it is
    two kernels at every head dim (dQ with D, then dK/dV), the Hopper
    bodies attn_plan names."""
    h, t = 2, 100
    qkv, g = _rn(dev, 1, t, 3 * h * d, seed=10), _rn(dev, 1, t, h * d, seed=11)
    out, lse = kattn.attention_fwd(qkv, h)
    assert kattn.attn_plan(1, h, t, d)["bwd_launches"] == launches
    kattn.reset_launch_counts()
    names = _kernel_names(lambda: kattn.attention_bwd(qkv, out, lse, g, h))
    assert kattn.LAUNCHES == {"attn_fwd": 0, "attn_bwd": 1}
    mine = [n for n in names if "cgd::" in n]
    assert len(mine) == launches and all(body in n for n in mine), names
    assert all(body in n for n in _kernel_names(lambda: kattn.attention_fwd(qkv, h)) if "cgd::" in n)


def test_the_attention_kernels_size_shared_memory_as_the_plan(dev):
    from cgd_tpu_torch.kernels import _build

    lib = _build.library()
    for d in kattn.HEAD_DIMS:
        plan = kattn.attn_plan(1, 4, 256, d)
        for i, kernel in enumerate(("fwd", "bwd_dq", "bwd_dkdv")):
            assert lib.cgd_attn_smem_bytes(i, d) == plan["smem"][kernel], (d, kernel)


def test_the_attention_entry_points_check_the_plan(dev):
    """A tile, stage count or split that this build does not take is
    refused (cudaErrorInvalidValue), not run."""
    from cgd_tpu_torch.kernels import _build

    qkv = _rn(dev, 1, 128, 3 * 64, seed=12)
    out = torch.empty(1, 128, 64, dtype=torch.bfloat16, device=dev)
    lse = torch.empty(1, 128, device=dev)
    lib, s = _build.library(), _build.stream(dev)
    p = (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), 1, 128, 1, 64)
    st = kattn.FWD_STAGES[64]
    assert lib.cgd_attn_fwd(*p, 64, st, 2, s) == 0
    for tile, stages, split in ((32, st, 2), (64, 2, 2), (64, st, 3)):
        assert lib.cgd_attn_fwd(*p, tile, stages, split, s) != 0
    one_tile = (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), 1, 64, 1, 64)
    assert lib.cgd_attn_fwd(*one_tile, 64, st, 2, s) != 0  # consumer 1 would see none
    # d = 256 runs a two-stage ring: the count of d = 64 is refused there
    qkv4 = _rn(dev, 1, 128, 3 * 256, seed=12)
    out4 = torch.empty(1, 128, 256, dtype=torch.bfloat16, device=dev)
    p4 = (qkv4.data_ptr(), out4.data_ptr(), lse.data_ptr(), 1, 128, 1, 256)
    assert lib.cgd_attn_fwd(*p4, 64, kattn.FWD_STAGES[256], 2, s) == 0
    assert lib.cgd_attn_fwd(*p4, 64, st, 2, s) != 0
    torch.cuda.synchronize()


def test_attention_function_uses_the_kernels(dev):
    qkv = _rn(dev, 1, 256, 3 * 512, seed=8).requires_grad_(True)
    kattn.reset_launch_counts()
    out = kattn.qkv_attention(qkv, 8)
    out.float().sum().backward()
    assert kattn.LAUNCHES == {"attn_fwd": 1, "attn_bwd": 1}
    assert out.dtype == qkv.grad.dtype == torch.bfloat16


def test_attention_unsupported_head_dim_or_dtype_raises(dev):
    with pytest.raises(ValueError, match="head dim 32"):
        kattn.attention_fwd(_rn(dev, 1, 16, 3 * 64), 2)
    with pytest.raises(TypeError, match="float32"):
        kattn.attention_fwd(_rn(dev, 1, 16, 3 * 64).float(), 1)


# K-halo: (batch, shard H, W, Cin, Cout): ragged tiles, Cin = 3 (conv_in),
# one-row shards, a split-K size
HALO = [(2, 12, 20, 64, 96), (1, 16, 16, 3, 256), (1, 1, 8, 32, 8), (1, 8, 16, 1024, 512)]


@pytest.mark.parametrize("shape", HALO)
@pytest.mark.parametrize("variant", ["plain", "prologue", "skip"])
def test_khalo_matches_plain(dev, shape, variant):
    b, h, w, ci, co = shape
    x, skip = _rn(dev, b, h, w, ci, seed=11), _rn(dev, b, h, w, co, seed=12)
    etop, ebot = _rn(dev, b, 1, w, ci, seed=13), _rn(dev, b, 1, w, ci, seed=14)
    wk = _rn(dev, 3, 3, ci, co, scale=(9 * ci) ** -0.5, seed=15)
    bias = _rn(dev, co, scale=0.1, seed=16)
    A = B = None
    if variant != "plain":
        A, B = 1.0 + 0.2 * _rn(dev, b, ci, seed=17).float(), 0.2 * _rn(dev, b, ci, seed=18).float()
    skip = skip if variant == "skip" else None
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(x, wk, bias, A, B, skip, etop=etop, ebot=ebot)
    assert k3.LAUNCHES["conv3x3_fwd_halo"] == 1 and k3.LAUNCHES["conv3x3_fwd"] == 0
    _close(out, k3.conv3x3_fwd_halo_plain(x, wk, bias, A, B, skip, etop, ebot))


def test_khalo_with_up_raises(dev):
    x = _rn(dev, 1, 8, 8, 32)
    with pytest.raises(ValueError, match="etop and ebot"):
        k3.conv3x3_fwd(x, _rn(dev, 3, 3, 32, 32), _rn(dev, 32), x.float()[:, 0, 0],
                       x.float()[:, 0, 0], up=True, etop=x[:, :1], ebot=x[:, :1])


@pytest.mark.parametrize("variant", ["plain", "gn", "gn_add"])
def test_split_conv_forward_and_gradient_match_plain(dev, variant):
    """Three shards on one card through conv_spmd against the plain halo conv
    with autograd."""
    ci, co = 64, 32
    xs = [_rn(dev, 1, 8, 24, ci, seed=20 + i) for i in range(3)]
    skips = [_rn(dev, 1, 8, 24, co, seed=30 + i) for i in range(3)]
    gs = [_rn(dev, 1, 8, 24, co, seed=40 + i) for i in range(3)]
    wk, bias = _rn(dev, 3, 3, ci, co, scale=(9 * ci) ** -0.5, seed=50), _rn(dev, co, seed=51)
    A = (1.0 + 0.2 * _rn(dev, 1, ci, seed=52).float()) if variant != "plain" else None
    B = (0.2 * _rn(dev, 1, ci, seed=53).float()) if variant != "plain" else None
    sk = skips if variant == "gn_add" else None

    def kernel(xs_):
        if A is None:
            return conv_spmd.conv3x3(xs_, wk, bias)
        if sk is None:
            return conv_spmd.conv3x3_gn_silu(xs_, A, B, wk, bias)
        return conv_spmd.conv3x3_gn_silu_add(xs_, A, B, wk, bias, sk)

    def plain(xs_):
        return conv_spmd.conv3x3_shards_plain(xs_, wk, bias, A, B, sk)

    results = []
    for fn in (kernel, plain):
        xs_ = [x.clone().requires_grad_(True) for x in xs]
        outs = fn(xs_)
        grads = torch.autograd.grad(outs, xs_, gs)
        results.append((torch.cat(outs, 1).detach(), torch.cat(grads, 1)))
    for got, want in zip(*results):
        _close(got, want)


def test_split_unet_matches_unsplit_and_runs_on_khalo(dev):
    """A small bf16 UNet split cut=2 on one card against the same UNet
    unsplit (relative L2 <= 5e-2, two bf16 routes); the split run launches
    K-halo and no unsplit conv."""
    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.ops.nn import cast_conv_params
    from cgd_tpu_torch.parallel.mesh import make_mesh, split_activation

    cfg = UNetConfig(image_size=64, model_channels=64, num_res_blocks=1, attention_ds=(2,),
                     channel_mult=(1, 2), num_head_channels=64, num_classes=10)
    gen = torch.Generator(dev).manual_seed(0)
    unet = cast_conv_params(UNet(cfg, device=dev).init_weights(gen), torch.bfloat16)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_((0.05 * torch.randn(p.shape, generator=gen, device=dev)).to(p.dtype))
    x = torch.randn(1, 64, 64, 3, generator=gen, device=dev)
    t, y = torch.tensor([300.0], device=dev), torch.tensor([2], device=dev)
    mesh = make_mesh([dev, dev])

    def run(split):
        x_ = x.clone().requires_grad_(True)
        out = unet(split_activation(x_, mesh) if split else x_, t, y, compute_dtype=torch.bfloat16)
        out = out.gather() if split else out
        return out.detach(), torch.autograd.grad(out.square().sum(), x_)[0]

    ref = run(False)
    k3.reset_launch_counts()
    got = run(True)
    assert k3.LAUNCHES["conv3x3_fwd_halo"] > 0
    assert k3.LAUNCHES["conv3x3_fwd"] == k3.LAUNCHES["conv3x3_dx"] == 0
    for a, b in zip(got, ref):
        assert ((a - b).norm() / b.norm()).item() <= 5e-2


# The Hopper main loop's instances: (batch, H, W, Cin, Cout, up) for each N
# tile (Cout 8 / 16 -> 16, 96 / 128 -> 128, 256 / 1024 -> 256), an image
# narrower than a 16-wide patch, up from a ragged source, and split K over
# chunk ranges that start past the first chunk (5 and 7 chunks)
MAINLOOP = [(1, 24, 24, 128, 8, False), (1, 20, 36, 64, 16, False), (1, 24, 40, 128, 96, False),
            (2, 16, 48, 64, 128, False), (1, 32, 32, 128, 256, False),
            (1, 16, 16, 256, 1024, False), (1, 8, 12, 128, 64, False), (1, 5, 9, 128, 128, True),
            (1, 7, 11, 64, 256, True), (1, 4, 4, 320, 128, False), (1, 8, 8, 448, 256, False)]


@pytest.mark.parametrize("shape,variant", [(s, v) for s in MAINLOOP
                                           for v in (["up"] if s[5] else ["plain", "prologue", "skip"])])
def test_kfwd_mainloop_instances_match_plain(dev, shape, variant):
    b, h, w, ci, co, up = shape
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    x, w_ = _rn(dev, b, h, w, ci, seed=60), _rn(dev, 3, 3, ci, co, scale=(9 * ci) ** -0.5, seed=61)
    bias, skip = _rn(dev, co, scale=0.1, seed=62), _rn(dev, b, ho, wo, co, seed=63)
    A = B = None
    if variant != "plain":
        A, B = 1.0 + 0.2 * _rn(dev, b, ci, seed=64).float(), 0.2 * _rn(dev, b, ci, seed=65).float()
    skip = skip if variant == "skip" else None
    out = k3.conv3x3_fwd(x, w_, bias, A, B, skip, up)
    _close(out, k3.conv3x3_fwd_plain(x, w_, bias, A, B, skip, up))
    assert torch.equal(out, k3.conv3x3_fwd(x, w_, bias, A, B, skip, up))


@pytest.mark.parametrize("shape", [s for s in MAINLOOP if not s[5]])
def test_kdx_mainloop_instances_match_plain_and_are_deterministic(dev, shape):
    b, h, w, ci, co, _ = shape
    x, g = _rn(dev, b, h, w, ci, seed=70), _rn(dev, b, h, w, co, seed=71)
    wt = k3._flip_t(_rn(dev, 3, 3, ci, co, scale=(9 * ci) ** -0.5, seed=72))
    A = 1.0 + 0.2 * _rn(dev, b, ci, seed=73).float()
    B = 0.2 * _rn(dev, b, ci, seed=74).float()
    got = k3.conv3x3_dx(g, wt, x, A, B)
    again = k3.conv3x3_dx(g, wt, x, A, B)
    for a, ref, c in zip(got, k3.conv3x3_dx_plain(g, wt, x, A, B), again):
        _close(a, ref)
        assert torch.equal(a, c)


@pytest.mark.parametrize("variant", ["plain", "prologue", "skip"])
def test_khalo_shard_of_height_8(dev, variant):
    """An 8-row shard: its one row of patches touches both neighbours."""
    b, h, w, ci, co = 1, 8, 40, 128, 256
    x, skip = _rn(dev, b, h, w, ci, seed=80), _rn(dev, b, h, w, co, seed=81)
    etop, ebot = _rn(dev, b, 1, w, ci, seed=82), _rn(dev, b, 1, w, ci, seed=83)
    wk, bias = _rn(dev, 3, 3, ci, co, scale=(9 * ci) ** -0.5, seed=84), _rn(dev, co, seed=85)
    A = B = None
    if variant != "plain":
        A, B = 1.0 + 0.2 * _rn(dev, b, ci, seed=86).float(), 0.2 * _rn(dev, b, ci, seed=87).float()
    skip = skip if variant == "skip" else None
    out = k3.conv3x3_fwd(x, wk, bias, A, B, skip, etop=etop, ebot=ebot)
    _close(out, k3.conv3x3_fwd_halo_plain(x, wk, bias, A, B, skip, etop, ebot))


def test_the_kernel_sizes_shared_memory_as_the_plan(dev):
    from cgd_tpu_torch.kernels import _build

    lib = _build.library()
    for bn in (16, 128, 256):
        for up in (False, True):
            assert lib.cgd_conv3x3_smem_bytes(bn, int(up)) == k3.smem_bytes(bn, up)[0]
    buf = torch.empty(256 ** 3, dtype=torch.bfloat16, device=dev)
    assert lib.cgd_conv3x3_encode_seconds(buf.data_ptr(), 10) > 0
