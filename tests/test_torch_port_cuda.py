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
                           "conv3x3_dx_wtiled": 0, "conv3x3_fwd_f32": 0,
                           "conv3x3_fwd_halo_f32": 0, "conv3x3_dx_f32": 0}
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


# K-fwd f32's fused modes and K-dx f32, held to their plain versions in f32
# at 1e-5 of the reference's max (3xTF32 with per-tap sums keeps f32's
# precision; chip_smoke.py phase 9 uses the same bound).
# (batch, H, W, Cin, Cout): ragged patches and N tiles, skinny channels, a
# Cin that is no multiple of 32, the UNet's deep level
F32_TOL = 1e-5
F32_MODE_SHAPES = [(2, 20, 36, 36, 20), (1, 16, 16, 3, 64), (1, 24, 24, 64, 6),
                   (1, 8, 8, 1024, 512), (2, 9, 17, 8, 100)]


def _close32(a, b):
    assert a.dtype == b.dtype == torch.float32
    assert (a - b).abs().max() <= F32_TOL * b.abs().max()


def _f32_mode_inputs(dev, b, h, w, ci, co, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    return dict(x=rn(b, h, w, ci), w=rn(3, 3, ci, co, scale=(9 * ci) ** -0.5),
                bias=rn(co, scale=0.1), A=1.0 + 0.2 * rn(b, ci), B=0.2 * rn(b, ci),
                skip=rn(b, h, w, co), g=rn(b, h, w, co))


@pytest.mark.parametrize("shape", F32_MODE_SHAPES)
@pytest.mark.parametrize("variant", ["prologue", "skip", "prologue_skip", "up"])
def test_kfwd_f32_fused_modes_match_plain(dev, full_f32, shape, variant):
    d = _f32_mode_inputs(dev, *shape)
    A, B = (None, None) if variant == "skip" else (d["A"], d["B"])
    skip = d["skip"] if "skip" in variant else None
    up = variant == "up"
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(d["x"], d["w"], d["bias"], A, B, skip, up)
    assert k3.LAUNCHES["conv3x3_fwd_f32"] == 1 and k3.LAUNCHES["conv3x3_fwd"] == 0
    b, h, w, _, co = shape
    assert out.shape == ((b, 2 * h, 2 * w, co) if up else (b, h, w, co))
    _close32(out, k3.conv3x3_fwd_plain(d["x"], d["w"], d["bias"], A, B, skip, up))


@pytest.mark.parametrize("shape", F32_MODE_SHAPES + [(1, 16, 520, 64, 32)])
def test_kdx_f32_matches_plain_and_is_deterministic(dev, full_f32, shape):
    """Both launch classes (the last shape is W >= 512): dx, dA, dB against
    the plain version, reruns bit-identical, one count each."""
    d = _f32_mode_inputs(dev, *shape, seed=3)
    wt = k3._flip_t(d["w"])
    k3.reset_launch_counts()
    got = k3.conv3x3_dx(d["g"], wt, d["x"], d["A"], d["B"])
    again = k3.conv3x3_dx(d["g"], wt, d["x"], d["A"], d["B"])
    assert k3.LAUNCHES["conv3x3_dx_f32"] == 2
    assert k3.LAUNCHES["conv3x3_dx"] == k3.LAUNCHES["conv3x3_dx_wtiled"] == 0
    for a, b, c in zip(got, k3.conv3x3_dx_plain(d["g"], wt, d["x"], d["A"], d["B"]), again):
        _close32(a, b)
        assert torch.equal(a, c)


def test_f32_autograd_functions_use_the_f32_kernels(dev, full_f32):
    """conv3x3_gn_silu_add at f32: forward on K-fwd f32, backward on K-dx
    f32; conv3x3_gn_silu_up: forward and its transpose conv on K-fwd f32."""
    d = _f32_mode_inputs(dev, 1, 16, 16, 64, 64, seed=4)
    x = d["x"].clone().requires_grad_(True)
    A = d["A"].clone().requires_grad_(True)
    k3.reset_launch_counts()
    out = k3.conv3x3_gn_silu_add(x, A, d["B"], d["w"], d["bias"], d["skip"])
    out.sum().backward()
    assert k3.LAUNCHES["conv3x3_fwd_f32"] == 1 and k3.LAUNCHES["conv3x3_dx_f32"] == 1
    assert x.grad.dtype == A.grad.dtype == torch.float32
    xp = d["x"].clone().requires_grad_(True)
    Ap = d["A"].clone().requires_grad_(True)
    pre = xp * Ap[:, None, None, :] + d["B"][:, None, None, :]
    ref = k3._conv_nhwc(pre * torch.sigmoid(pre), d["w"]) + d["bias"] + d["skip"]
    ref.sum().backward()
    _close32(x.grad, xp.grad)
    _close32(A.grad, Ap.grad)
    k3.reset_launch_counts()
    xu = d["x"].clone().requires_grad_(True)
    k3.conv3x3_gn_silu_up(xu, d["A"], d["B"], d["w"], d["bias"]).sum().backward()
    assert k3.LAUNCHES["conv3x3_fwd_f32"] == 2 and k3.LAUNCHES["conv3x3_dx_f32"] == 0


# K-halo f32 shards (batch, shard H, W, Cin, Cout): shorter than the 8-row
# patch (the 8^2 level at cut=2 and cut=4), a height and a width that are no
# multiple of 8 / 16, Cin 3 (conv_in), the 16^2 level's 2048 -> 1024 shard
F32_HALO = [(1, 4, 16, 64, 64), (2, 12, 24, 64, 96), (1, 2, 8, 128, 64), (1, 8, 16, 3, 32),
            (1, 8, 16, 2048, 1024)]


@pytest.mark.parametrize("shape", F32_HALO)
@pytest.mark.parametrize("variant", ["plain", "prologue", "prologue_skip"])
def test_khalo_f32_matches_plain(dev, full_f32, shape, variant):
    """K-halo f32 against its plain version: the neighbour rows are random
    (post-activation values are never activated again; a kernel that did
    would miss by far more than the bound)."""
    b, h, w, ci, co = shape
    d = _f32_mode_inputs(dev, b, h, w, ci, co, seed=5)
    gen = torch.Generator(dev).manual_seed(6)
    etop, ebot = (torch.randn(b, 1, w, ci, generator=gen, device=dev) for _ in range(2))
    A, B = (None, None) if variant == "plain" else (d["A"], d["B"])
    skip = d["skip"] if variant == "prologue_skip" else None
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(d["x"], d["w"], d["bias"], A, B, skip, etop=etop, ebot=ebot)
    assert k3.LAUNCHES["conv3x3_fwd_halo_f32"] == 1
    assert k3.LAUNCHES["conv3x3_fwd_f32"] == k3.LAUNCHES["conv3x3_fwd_halo"] == 0
    assert out.shape == (b, h, w, co)
    _close32(out, k3.conv3x3_fwd_halo_plain(d["x"], d["w"], d["bias"], A, B, skip, etop, ebot))


@pytest.mark.parametrize("variant", ["plain", "gn", "gn_add"])
def test_split_conv_f32_forward_and_gradient_match_plain(dev, full_f32, variant):
    """Three f32 shards (a 4-row one among them) on one card through
    conv_spmd against the plain halo conv with autograd: forward and input
    gradient on K-halo f32, nothing on the bf16 kernels."""
    ci, co = 64, 32
    gen = torch.Generator(dev).manual_seed(7)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    xs = [rn(1, h, 24, ci) for h in (8, 4, 12)]
    skips, gs = [rn(1, x.shape[1], 24, co) for x in xs], [rn(1, x.shape[1], 24, co) for x in xs]
    wk, bias = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
    A = 1.0 + 0.2 * rn(1, ci) if variant != "plain" else None
    B = 0.2 * rn(1, ci) if variant != "plain" else None
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
        k3.reset_launch_counts()
        xs_ = [x.clone().requires_grad_(True) for x in xs]
        outs = fn(xs_)
        grads = torch.autograd.grad(outs, xs_, gs)
        results.append((torch.cat(outs, 1).detach(), torch.cat(grads, 1)))
        if fn is kernel:  # three shards forward, three for the input gradient
            assert k3.LAUNCHES["conv3x3_fwd_halo_f32"] == 6
            assert sum(k3.LAUNCHES.values()) == 6
    for got, want in zip(*results):
        _close32(got, want)


def test_split_f32_unet_matches_unsplit_and_runs_on_khalo_f32(dev, full_f32):
    """A small f32 UNet split cut=2 on one card against the same UNet
    unsplit on the f32 kernels (relative L2 <= 1e-4, chip_smoke.py's
    F32_UNET_TOL); the split run launches K-halo f32 and no other conv
    kernel."""
    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.parallel.mesh import make_mesh, split_activation

    cfg = UNetConfig(image_size=64, model_channels=64, num_res_blocks=1, attention_ds=(2,),
                     channel_mult=(1, 2), num_head_channels=64, num_classes=10)
    gen = torch.Generator(dev).manual_seed(0)
    unet = UNet(cfg, device=dev).init_weights(gen)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen, device=dev))
    x = torch.randn(1, 64, 64, 3, generator=gen, device=dev)
    t, y = torch.tensor([300.0], device=dev), torch.tensor([2], device=dev)
    mesh = make_mesh([dev, dev])

    def run(split):
        x_ = x.clone().requires_grad_(True)
        out = unet(split_activation(x_, mesh) if split else x_, t, y, compute_dtype=torch.float32)
        out = out.gather() if split else out
        return out.detach(), torch.autograd.grad(out.square().sum(), x_)[0]

    ref = run(False)
    k3.reset_launch_counts()
    got = run(True)
    assert k3.LAUNCHES["conv3x3_fwd_halo_f32"] > 0
    assert sum(k3.LAUNCHES.values()) == k3.LAUNCHES["conv3x3_fwd_halo_f32"]
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        assert ((a - b).norm() / b.norm()).item() <= 1e-4


def _c_plan(lib, b, h, w, ci, co, up):
    import ctypes

    out = (ctypes.c_int * 18)()
    assert lib.cgd_conv3x3_f32_plan(b, h, w, ci, co, int(up), out) == 0
    keys = ("bn", "ph", "pw", "k8_steps", "chunks", "ksplit", "win_stages", "slab_stages",
            "smem_bytes", "patches", "threads", "wr", "wc", "slot", "smem_cap", "sms", "tiles",
            "blocks")
    return dict(zip(keys, out))


def test_the_f32_halo_kernel_sizes_shared_memory_as_the_plan_and_checks_its_rows(dev):
    """K-halo f32 takes the geometry and shared memory f32_plan(halo=True)
    gives; the C entry point refuses one halo row without the other, a halo
    with up, and any geometry but the plan's."""
    from cgd_tpu_torch.kernels import _build

    lib = _build.library()
    plan = k3.f32_plan(1, 4, 16, 64, 64, halo=True, sms=k3._sms(dev))
    got = _c_plan(lib, 1, 4, 16, 64, 64, False)
    assert (got["bn"], (got["ph"], got["pw"]), got["smem_bytes"]) == (
        plan["bn"], plan["patch"], plan["smem_bytes"])
    x, w, bias = _f32_inputs(dev, 1, 4, 16, 64, 64)
    A = torch.ones(1, 64, device=dev)
    rows = torch.zeros(1, 1, 16, 64, device=dev)
    out = torch.empty(1, 8, 32, 64, device=dev)
    wsplit = torch.empty(plan["wsplit"], device=dev)
    ws = torch.empty(plan["ws_floats"], device=dev)
    p = [t.data_ptr() for t in (x, w, bias, A, rows, out, wsplit, ws)]
    stream = _build.stream(dev)
    bn, ph, ks = plan["bn"], plan["patch"][0], plan["ksplit"]
    for pro, etop, ebot, up, geom in ((None, p[4], None, 0, (bn, ph, ks)),
                                      (None, None, p[4], 0, (bn, ph, ks)),
                                      (p[3], p[4], p[4], 1, (bn, ph, ks)),
                                      (None, p[4], p[4], 0, (64 if bn != 64 else 128, ph, ks)),
                                      (None, p[4], p[4], 0, (bn, 8, ks)),
                                      (None, p[4], p[4], 0, (bn, ph, ks + 1))):
        assert lib.cgd_conv3x3_f32(p[0], p[1], p[2], pro, pro, None, etop, ebot, p[5], p[6],
                                   p[7] if geom[2] > 1 else None, 1, 4, 16, 64, 64, up,
                                   *geom, stream) != 0


# shapes of every f32 plan class: the UNets' large, split-K (16^2 and 8^2
# levels, the VGG's 16^2), narrow-K (Cin 3, K-dx's 6-channel cotangent),
# narrow-N (Cout 6 and 3), up, and the short shards of the 8^2 level
F32_PLAN_SHAPES = [(1, 256, 256, 256, 256, False), (1, 16, 16, 2048, 1024, False),
                   (1, 8, 8, 1024, 1024, False), (1, 16, 16, 512, 512, False),
                   (1, 256, 256, 4, 256, False), (1, 256, 256, 8, 256, False),
                   (1, 256, 256, 256, 8, False), (1, 256, 256, 64, 4, False),
                   (1, 64, 64, 512, 512, True), (1, 8, 8, 1024, 512, True),
                   (1, 4, 8, 1024, 1024, False), (1, 2, 8, 1024, 1024, False),
                   (1, 512, 512, 256, 128, False), (2, 9, 17, 8, 100, False)]


@pytest.mark.parametrize("shape", F32_PLAN_SHAPES)
def test_the_f32_kernel_sizes_shared_memory_as_the_plan(dev, shape):
    """The C side's plan (cgd_conv3x3_f32_plan, what the entry points check
    their callers against) equals f32_plan at this card's SM count."""
    from cgd_tpu_torch.kernels import _build

    b, h, w, ci, co, up = shape
    got = _c_plan(_build.library(), *shape)
    plan = k3.f32_plan(b, h, w, ci, co, up=up, sms=k3._sms(dev))
    assert got["sms"] == k3._sms(dev)
    assert (got["bn"], (got["ph"], got["pw"]), got["k8_steps"], got["chunks"],
            got["ksplit"]) == (plan["bn"], plan["patch"], plan["k8_steps"], plan["chunks"],
                               plan["ksplit"])
    assert (got["win_stages"], got["slab_stages"], got["smem_bytes"], got["threads"]) == (
        plan["win_stages"], plan["slab_stages"], plan["smem_bytes"], plan["threads"])
    assert (got["wr"], got["wc"], got["slot"], got["patches"]) == (
        *plan["window"], plan["slot"], plan["tile_grid"][0])
    assert (got["tiles"], got["blocks"]) == (plan["tiles"], plan["blocks"])
    assert plan["smem_bytes"] <= got["smem_cap"] == k3.SMEM_MAX - k3.F32_STATIC


@pytest.mark.parametrize("cin,cout", [(4, 8), (8, 256), (12, 20), (64, 100), (2048, 1024),
                                      (256, 4)])
def test_the_f32_weight_split_matches_its_plain_version(dev, cin, cout):
    """The weight split kernel against split_weights_plain, bit for bit."""
    from cgd_tpu_torch.kernels import _build

    w = torch.randn(3, 3, cin, cout, generator=torch.Generator(dev).manual_seed(8),
                    device=dev)
    want = k3.split_weights_plain(w)
    got = torch.empty_like(want)
    assert _build.library().cgd_conv3x3_f32_split(w.data_ptr(), got.data_ptr(), cin, cout,
                                                  _build.stream(dev)) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["plain", "prologue", "skip", "prologue_skip", "up", "halo",
                                     "halo_prologue_skip", "dx"])
@pytest.mark.parametrize("cin,cout", [(3, 64), (256, 6), (6, 256), (64, 3)])
def test_the_narrow_channels_match_plain_in_every_mode(dev, full_f32, variant, cin, cout):
    """Cin = 3 (conv_in), Cout = 6 (eps/sigma), K-dx into 6 channels and the
    3-channel input gradient, each in every mode, at 1e-5 of the max."""
    b, h, w = 1, 24, 40
    d = _f32_mode_inputs(dev, b, h, w, cin, cout, seed=11)
    if variant == "dx":
        wt = k3._flip_t(d["w"])
        for a, c in zip(k3.conv3x3_dx(d["g"], wt, d["x"], d["A"], d["B"]),
                        k3.conv3x3_dx_plain(d["g"], wt, d["x"], d["A"], d["B"])):
            _close32(a, c)
        return
    pro = "prologue" in variant or variant == "up"
    A, B = (d["A"], d["B"]) if pro else (None, None)
    skip = d["skip"] if "skip" in variant else None
    if variant.startswith("halo"):
        gen = torch.Generator(dev).manual_seed(12)
        etop, ebot = (torch.randn(b, 1, w, cin, generator=gen, device=dev) for _ in range(2))
        _close32(k3.conv3x3_fwd(d["x"], d["w"], d["bias"], A, B, skip, etop=etop, ebot=ebot),
                 k3.conv3x3_fwd_halo_plain(d["x"], d["w"], d["bias"], A, B, skip, etop, ebot))
        return
    up = variant == "up"
    _close32(k3.conv3x3_fwd(d["x"], d["w"], d["bias"], A, B, skip, up),
             k3.conv3x3_fwd_plain(d["x"], d["w"], d["bias"], A, B, skip, up))


@pytest.mark.parametrize("shape", [(1, 16, 16, 512, 512), (1, 8, 8, 1024, 256), (1, 4, 8, 256, 128),
                                   (1, 2, 8, 256, 128)])
def test_split_k_is_bit_identical_over_two_runs(dev, full_f32, shape):
    """Shapes planned with split K: K-fwd f32 (prologue + residual), K-halo
    f32 on the short shards and K-dx f32, rerun bit-identical, within 1e-5."""
    b, h, w, ci, co = shape
    assert "split_k" in k3.f32_plan(b, h, w, ci, co, sms=k3._sms(dev))["classes"]
    d = _f32_mode_inputs(dev, *shape, seed=13)
    etop, ebot = d["x"][:, :1] * 0.5, d["x"][:, -1:] * 0.5
    runs = {
        "fwd": lambda: k3.conv3x3_fwd(d["x"], d["w"], d["bias"], d["A"], d["B"], d["skip"]),
        "halo": lambda: k3.conv3x3_fwd(d["x"], d["w"], d["bias"], d["A"], d["B"], d["skip"],
                                       etop=etop, ebot=ebot),
        "dx": lambda: k3.conv3x3_dx(d["g"], k3._flip_t(d["w"]), d["x"], d["A"], d["B"]),
    }
    plain = {
        "fwd": lambda: k3.conv3x3_fwd_plain(d["x"], d["w"], d["bias"], d["A"], d["B"], d["skip"]),
        "halo": lambda: k3.conv3x3_fwd_halo_plain(d["x"], d["w"], d["bias"], d["A"], d["B"],
                                                  d["skip"], etop, ebot),
        "dx": lambda: k3.conv3x3_dx_plain(d["g"], k3._flip_t(d["w"]), d["x"], d["A"], d["B"]),
    }
    for name, fn in runs.items():
        got, again, want = fn(), fn(), plain[name]()
        got, again, want = ((z,) if torch.is_tensor(z) else z for z in (got, again, want))
        for a, c, e in zip(got, again, want):
            assert torch.equal(a, c), name
            _close32(a, e)


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
                           "conv3x3_dx_wtiled": 2, "conv3x3_fwd_f32": 0,
                           "conv3x3_fwd_halo_f32": 0, "conv3x3_dx_f32": 0}
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
    assert kattn.LAUNCHES == {"attn_fwd": 1, "attn_bwd": 2, "attn_fwd_f32": 0, "attn_bwd_f32": 0}
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
    assert kattn.LAUNCHES == {"attn_fwd": 0, "attn_bwd": 1, "attn_fwd_f32": 0, "attn_bwd_f32": 0}
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
    p = (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), 1, 128, 1, 64, 64)
    st = kattn.FWD_STAGES[64]
    assert lib.cgd_attn_fwd(*p, 64, st, 2, s) == 0
    for tile, stages, split in ((32, st, 2), (64, 2, 2), (64, st, 3)):
        assert lib.cgd_attn_fwd(*p, tile, stages, split, s) != 0
    one_tile = (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), 1, 64, 1, 64, 64)
    assert lib.cgd_attn_fwd(*one_tile, 64, st, 2, s) != 0  # consumer 1 would see none
    # d = 256 runs a two-stage ring: the count of d = 64 is refused there
    qkv4 = _rn(dev, 1, 128, 3 * 256, seed=12)
    out4 = torch.empty(1, 128, 256, dtype=torch.bfloat16, device=dev)
    p4 = (qkv4.data_ptr(), out4.data_ptr(), lse.data_ptr(), 1, 128, 1, 256, 256)
    assert lib.cgd_attn_fwd(*p4, 64, kattn.FWD_STAGES[256], 2, s) == 0
    assert lib.cgd_attn_fwd(*p4, 64, st, 2, s) != 0
    # the scale's head dim lies in 1..d
    for dh in (0, 257):
        assert lib.cgd_attn_fwd(*p4[:-1], dh, 64, kattn.FWD_STAGES[256], 2, s) != 0
    torch.cuda.synchronize()


def test_attention_function_uses_the_kernels(dev):
    qkv = _rn(dev, 1, 256, 3 * 512, seed=8).requires_grad_(True)
    kattn.reset_launch_counts()
    out = kattn.qkv_attention(qkv, 8)
    out.float().sum().backward()
    assert kattn.LAUNCHES == {"attn_fwd": 1, "attn_bwd": 1, "attn_fwd_f32": 0, "attn_bwd_f32": 0}
    assert out.dtype == qkv.grad.dtype == torch.bfloat16


def test_attention_unsupported_head_dim_or_dtype_raises(dev):
    # a head dim between the templates runs padded (test_torch_port_attention_pad_cuda.py);
    # one past the widest has no kernel
    with pytest.raises(ValueError, match="head dim 320"):
        kattn.attention_fwd(_rn(dev, 1, 16, 3 * 320), 1)
    with pytest.raises(TypeError, match="float64"):
        kattn.attention_fwd(_rn(dev, 1, 16, 3 * 64).double(), 1)


# K-attn-f / K-attn-b f32 (csrc/attn_f32.cu) against their plain versions in
# f32 at 1e-5 of the reference's max (3xTF32 on the tensor cores against
# cuBLAS's f32, summed in other orders), at the bf16 cases and the 256px
# UNet's 16^2 level
ATTN32 = ATTN + [(1, 16, 256, 64)]


@pytest.mark.parametrize("b,h,t,d", ATTN32)
def test_f32_attention_kernels_match_plain_and_backward_is_deterministic(dev, b, h, t, d):
    gen = torch.Generator(dev).manual_seed(13)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev)
    g = torch.randn(b, t, h * d, generator=gen, device=dev)
    kattn.reset_launch_counts()
    out, lse = kattn.attention_fwd(qkv, h)
    q, k, v = kattn.split_heads(qkv, h)
    _close32(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), b))
    logits = (q @ k.transpose(-1, -2)) / d ** 0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-5, rtol=0)
    dqkv = kattn.attention_bwd(qkv, out, lse, g, h)
    assert torch.equal(dqkv, kattn.attention_bwd(qkv, out, lse, g, h))
    refs = kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g, h))
    for got, ref in zip(dqkv.chunk(3, dim=-1), refs):
        _close32(got, kattn.merge_heads(ref, b))
    assert kattn.LAUNCHES == {"attn_fwd": 0, "attn_bwd": 0, "attn_fwd_f32": 1, "attn_bwd_f32": 2}
    assert kattn.LAUNCHES_BY_D[d] == kattn.LAUNCHES


def test_the_f32_attention_kernels_size_shared_memory_as_the_plan(dev):
    from cgd_tpu_torch.kernels import _build

    lib = _build.library()
    for d in kattn.HEAD_DIMS:
        plan = kattn.f32_attn_plan(1, 4, 256, d)
        for i, kernel in enumerate(("fwd", "bwd_dq", "bwd_dkdv")):
            assert lib.cgd_attn_f32_smem_bytes(i, d) == plan["smem"][kernel], (d, kernel)


def test_the_f32_attention_entry_points_check_the_plan(dev):
    """Each C entry point launches the plan's geometry (streamed tiles,
    stages, 64-column shares) and refuses any other."""
    from cgd_tpu_torch.kernels import _build

    qkv = torch.randn(1, 128, 3 * 256, device=dev)
    out = torch.empty(1, 128, 256, device=dev)
    lse = torch.empty(1, 128, device=dev)
    lib, s = _build.library(), _build.stream(dev)
    plan = kattn.f32_attn_plan(1, 1, 128, 256)
    st, sg, cols = plan["stream"], plan["stages"], plan["cols"]
    p = (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), 1, 128, 1, 256, 256)
    assert lib.cgd_attn_fwd_f32(*p, st["fwd"], sg["fwd"], cols, s) == 0
    for bad in ((16, sg["fwd"], cols), (st["fwd"], 2, cols), (st["fwd"], sg["fwd"], 128)):
        assert lib.cgd_attn_fwd_f32(*p, *bad, s) != 0, bad
    dqkv = torch.empty_like(qkv)
    dvec = torch.empty(1, 128, device=dev)
    pb = (qkv.data_ptr(), out.data_ptr(), out.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
          dqkv.data_ptr(), 1, 128, 1, 256, 256)
    assert st["bwd_dq"] == st["bwd_dkdv"] and sg["bwd_dq"] == sg["bwd_dkdv"]
    assert lib.cgd_attn_bwd_f32(*pb, st["bwd_dq"], sg["bwd_dq"], cols, s) == 0
    for bad in ((32, 3, 64), (16, 4, 64), (16, 3, 256)):  # d = 256: 16 rows, three stages
        assert lib.cgd_attn_bwd_f32(*pb, *bad, s) != 0, bad
    torch.cuda.synchronize()


def test_f32_attention_function_uses_the_f32_kernels(dev):
    qkv = torch.randn(1, 256, 3 * 512, device=dev, requires_grad=True)
    kattn.reset_launch_counts()
    out = kattn.qkv_attention(qkv, 4)
    out.sum().backward()
    assert kattn.LAUNCHES == {"attn_fwd": 0, "attn_bwd": 0, "attn_fwd_f32": 1, "attn_bwd_f32": 1}
    assert out.dtype == qkv.grad.dtype == torch.float32


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


# the 64px model's shapes (batch, H, Cin, Cout): Cout 192 / 384 / 576 fill
# their 256-wide N tiles partly (one tile with 64 dead columns, a second tile
# half empty, a third with 64 live columns), 768 fills three; K-dx at
# Cx = 192 / 384 / 576 / 768; the 6-channel output conv
SHAPES_64 = [(1, 64, 192, 192), (1, 32, 192, 384), (1, 32, 384, 384), (1, 16, 576, 576),
             (1, 8, 768, 768), (1, 64, 192, 6), (2, 16, 576, 384)]


@pytest.mark.parametrize("shape", SHAPES_64)
@pytest.mark.parametrize("variant", ["plain", "prologue", "skip", "up"])
def test_kfwd_matches_plain_at_the_64px_shapes(dev, shape, variant):
    test_kfwd_matches_plain(dev, shape, variant)


@pytest.mark.parametrize("shape", SHAPES_64)
def test_kdx_matches_plain_at_the_64px_shapes(dev, shape):
    test_kdx_matches_plain_and_is_deterministic(dev, shape)


@pytest.mark.parametrize("h,w,ci,co,prologue", [(72, 64, 192, 192, True),
                                                (16, 24, 576, 576, True),
                                                (128, 192, 3, 256, False),
                                                (9, 12, 768, 768, True)])
def test_non_square_images_match_plain(dev, h, w, ci, co, prologue):
    """The offsets' non-square samples: K-fwd (with its prologue and the
    residual, or plain as conv_in runs it) and K-dx on an h x w image,
    against their plain versions."""
    gen = torch.Generator(dev).manual_seed(3)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)

    x, w_, bias = rn(1, h, w, ci), rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
    A = 1.0 + 0.2 * torch.randn(1, ci, generator=gen, device=dev) if prologue else None
    B = 0.2 * torch.randn(1, ci, generator=gen, device=dev) if prologue else None
    skip, g = rn(1, h, w, co) if prologue else None, rn(1, h, w, co)
    _close(k3.conv3x3_fwd(x, w_, bias, A, B, skip), k3.conv3x3_fwd_plain(x, w_, bias, A, B, skip))
    if prologue:
        wt = k3._flip_t(w_)
        for a, b in zip(k3.conv3x3_dx(g, wt, x, A, B), k3.conv3x3_dx_plain(g, wt, x, A, B)):
            _close(a, b)


@pytest.mark.parametrize("b,h,t,d", [(1, 6, 1024, 64), (1, 9, 256, 64), (1, 12, 64, 64),
                                     (2, 9, 256, 64), (1, 9, 384, 64)])
def test_attention_at_the_64px_head_counts(dev, b, h, t, d):
    """The 64px model's 6 / 9 / 12 heads (odd grids), and T = 384 of the
    128 x 192 sample's 16 x 24 level."""
    test_attention_kernels_match_plain_and_backward_is_deterministic(dev, b, h, t, d)


@pytest.mark.parametrize("fast", [False, True])
def test_fast_guidance_launches_no_backward_kernel(dev, fast):
    """One guided bf16 step of a small UNet (64 / 128 channels, two heads of
    d = 64 at 16^2) with a loss on the blend: with fast_guidance no K-dx,
    K-dx-w or K-attn-b launches (the UNet runs no backward); without it
    they do."""
    from cgd_tpu_torch.diffusion.gaussian import make_diffusion
    from cgd_tpu_torch.diffusion.sampler import GuidanceFns, SamplerConfig, make_guided_step
    from cgd_tpu_torch.models.unet import UNet, UNetConfig
    from cgd_tpu_torch.ops.nn import cast_conv_params

    cfg = UNetConfig(image_size=32, model_channels=64, num_res_blocks=1, attention_ds=(2,),
                     channel_mult=(1, 2), num_head_channels=64, num_classes=10)
    gen = torch.Generator(dev).manual_seed(0)
    unet = UNet(cfg, device=dev).init_weights(gen)
    cast_conv_params(unet, torch.bfloat16)

    def loss_fn(x, out, ref_t, g):
        return (out.pred_xstart * 0.5 + x * 0.5).square().sum(), {}

    step = make_guided_step(
        make_diffusion(timestep_respacing="ddim10"),
        lambda x, t, y: unet(x, t, y, compute_dtype=torch.bfloat16),
        GuidanceFns(loss_fn, lambda grad: (grad, {})),
        SamplerConfig(use_ddim=True, fast_guidance=fast))
    k3.reset_launch_counts()
    kattn.reset_launch_counts()
    x_next = step(torch.randn(1, 32, 32, 3, generator=gen, device=dev), 5, 5,
                  torch.tensor([1], device=dev), gen)[0]
    torch.cuda.synchronize()
    backward = k3.LAUNCHES["conv3x3_dx"] + k3.LAUNCHES["conv3x3_dx_wtiled"] + \
        kattn.LAUNCHES["attn_bwd"]
    assert torch.isfinite(x_next).all()
    assert k3.LAUNCHES["conv3x3_fwd"] > 0 and kattn.LAUNCHES["attn_fwd"] > 0
    assert (backward == 0) == fast


@pytest.mark.parametrize("n,size,draw", [(16, 224, "random"), (4, 24, "random"), (16, 64, "long")])
def test_the_warp_backward_matches_plain_and_reruns_identically(dev, n, size, draw):
    """K-warp-b (the augmentation warp's backward, csrc/warp_bwd.cu) and its
    index K-warp-i (csrc/warp_index.cu) at the warp apply_augs builds on the
    card (16 cutouts of 224^2 on the main path; "long": warp_bench's draw
    whose clamped corners collect hundreds of pairs a tap, more than one
    round of the long-segment path): the index equal to its plain version's
    run on the CPU, field by field; K-warp-b against its plain version run
    on the CPU on the same index and cotangent, bit-equal (it adds in the
    plain version's order, each product and sum rounded alone);
    apply_augs' input gradient ten times bit-identical, one launch of each
    a backward."""
    from cgd_tpu_torch.guidance import cutouts
    from cgd_tpu_torch.kernels import warp
    from cgd_tpu_torch.tools.warp_bench import long_draw

    gen = torch.Generator(dev).manual_seed(3)
    cuts = torch.rand(n, size, size, 3, generator=gen, device=dev)
    probe = torch.randn(n, size, size, 3, generator=gen, device=dev)
    d = long_draw(n, size, dev) if draw == "long" else cutouts.draw_augs(gen, n, size, size, 3)
    seen, real = [], warp.bilinear_warp

    def spy(x, idx, weight):
        seen.append((idx, weight))
        return real(x, idx, weight)

    grads = []
    warp.reset_launch_counts()
    warp.bilinear_warp = spy
    try:
        for _ in range(10):
            x = cuts.clone().requires_grad_(True)
            (cutouts.apply_augs(x, d) * probe).sum().backward()
            grads.append(x.grad)
    finally:
        warp.bilinear_warp = real
    torch.cuda.synchronize()
    assert warp.LAUNCHES == {"warp_bwd": 10, "warp_index": 10}
    assert all(torch.equal(g, grads[0]) for g in grads[1:])
    idx, weight = seen[0]
    index = warp.warp_index(idx, weight)
    plain = warp.warp_index_plain(idx.cpu(), weight.cpu())
    for name, got_t, want_t in zip(warp.WarpIndex._fields, index, plain):
        assert torch.equal(got_t.cpu(), want_t), name
    if draw == "long":
        assert int(index.offsets.diff().max()) > 128 and int(index.n_long) > 100
    g = torch.randn(n * size * size, 3, generator=gen, device=dev)
    got = warp.warp_bwd(g, index)
    want = warp.warp_bwd_plain(g.cpu(), plain)
    assert torch.equal(got.cpu(), want), float((got.cpu() - want).abs().max())
