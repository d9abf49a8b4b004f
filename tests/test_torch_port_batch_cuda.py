"""The port's kernels at b > 1 images, on a card (chip_smoke.py phase 14a at
smaller sizes).

Marked ``cuda``: without a card every test skips (the kernels have no CPU
mode). This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_batch_cuda.py

Each kernel at b images against its plain version (bf16: max |err| <= 1%
of the reference's max; f32: 1e-5), and each image of the batch against
the kernel on that image alone: bit-equal where the launch plan (split K)
is the same at b and at 1 (the kernels use no atomics), else within the
same bound.
"""

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch.kernels import attention as kattn  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402
from cgd_tpu_torch.kernels import conv_spmd  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def dev():
    """The card, with cuDNN's TF32 off while the test runs: the f32 plain
    versions are cuDNN convs, which PyTorch lets run at TF32 by default."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = prev


def _close(a, b, dtype):
    assert (a.float() - b.float()).abs().max() <= TOL[dtype] * b.float().abs().max()


def _per_image(batched, alone, same, dtype):
    for i, outs in enumerate(alone):
        for a, b in zip(batched, outs):
            if same:
                assert torch.equal(a[i:i + 1], b), f"image {i}"
            else:
                _close(a[i:i + 1], b, dtype)


def _rn(dev, dtype, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def rn(*s, scale=1.0, base=None):
        t = torch.randn(*s, generator=gen, device=dev) * scale
        return t + base if base is not None else t.to(dtype)

    return rn


def _ksplit(dtype, b, h, w, ci, co, **kw):
    """Split K of the launch at b images of h x w (``dx``: K-dx's)."""
    if dtype == torch.float32:
        return k3.f32_plan(b, h, w, ci, co, **kw)["ksplit"]
    kw.pop("dx", None)
    return k3.conv_plan(b, h, w, ci, co, **kw)["ksplit"]


# (H, Cin, Cout): a 256px-level conv, the 16^2 split-K level, the eps conv
CONVS = [(32, 256, 256), (16, 2048, 1024), (32, 256, 6)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [2, 4, 8])
@pytest.mark.parametrize("shape", CONVS)
@pytest.mark.parametrize("variant", ["plain", "prologue+skip", "up"])
def test_kfwd_at_b_images(dev, dtype, b, shape, variant):
    h, ci, co = shape
    rn = _rn(dev, dtype)
    up = variant == "up"
    hs = h // 2 if up else h
    x, w, bias = rn(b, hs, hs, ci), rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
    A = B = skip = None
    if variant != "plain":
        A, B = rn(b, ci, scale=0.2, base=1.0), rn(b, ci, scale=0.2, base=0.0)
    if variant == "prologue+skip":
        skip = rn(b, h, h, co)

    def call(lo, hi, fn=k3.conv3x3_fwd):
        cut = [None if t is None else t[lo:hi] for t in (x, A, B, skip)]
        return (fn(cut[0], w, bias, cut[1], cut[2], cut[3], up),)

    got = call(0, b)
    _close(got[0], call(0, b, k3.conv3x3_fwd_plain)[0], dtype)
    same = _ksplit(dtype, b, hs, hs, ci, co, up=up) == _ksplit(dtype, 1, hs, hs, ci, co, up=up)
    _per_image(got, [call(i, i + 1) for i in range(b)], same, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [2, 4, 8])
@pytest.mark.parametrize("shape", [(32, 256, 256), (16, 1024, 2048), (32, 6, 256)])
def test_kdx_at_b_images_with_per_image_da_db(dev, dtype, b, shape):
    """K-dx (cotangent Cg -> Cx): dx, and dA / dB [b, Cx], per image."""
    h, cg, cx = shape
    rn = _rn(dev, dtype, 1)
    g, wt, x = rn(b, h, h, cg), rn(3, 3, cg, cx, scale=(9 * cg) ** -0.5), rn(b, h, h, cx)
    A, B = rn(b, cx, scale=0.2, base=1.0), rn(b, cx, scale=0.2, base=0.0)

    def call(lo, hi, fn=k3.conv3x3_dx):
        return fn(g[lo:hi], wt, x[lo:hi], A[lo:hi], B[lo:hi])

    got = call(0, b)
    for a, r in zip(got, call(0, b, k3.conv3x3_dx_plain)):
        _close(a, r, dtype)
    same = _ksplit(dtype, b, h, h, cg, cx, dx=True) == _ksplit(dtype, 1, h, h, cg, cx, dx=True)
    _per_image(got, [call(i, i + 1) for i in range(b)], same, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_kdx_w_at_512_with_two_images(dev, dtype):
    rn = _rn(dev, dtype, 2)
    b, ci, co = 2, 128, 128
    g, wt, x = rn(b, 512, 512, co), rn(3, 3, co, ci, scale=(9 * co) ** -0.5), rn(b, 512, 512, ci)
    A, B = rn(b, ci, scale=0.2, base=1.0), rn(b, ci, scale=0.2, base=0.0)
    k3.reset_launch_counts()
    got = k3.conv3x3_dx(g, wt, x, A, B)
    key = "conv3x3_dx_f32" if dtype == torch.float32 else "conv3x3_dx_wtiled"
    assert k3.LAUNCHES[key] == 1
    for a, r in zip(got, k3.conv3x3_dx_plain(g, wt, x, A, B)):
        _close(a, r, dtype)
    _per_image(got, [k3.conv3x3_dx(g[i:i + 1], wt, x[i:i + 1], A[i:i + 1], B[i:i + 1])
                     for i in range(b)], True, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shard", [(16, 32, 256, 256), (4, 8, 1024, 1024)])
def test_khalo_on_two_image_shards(dev, dtype, shard):
    """conv_spmd's prologue + residual conv over two shards of two images
    each, forward and input gradient."""
    hs, wd, ci, co = shard
    rn = _rn(dev, dtype, 3)
    b = 2
    xs = [rn(b, hs, wd, ci) for _ in range(2)]
    w, bias = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5), rn(co, scale=0.1)
    A, B = rn(b, ci, scale=0.2, base=1.0), rn(b, ci, scale=0.2, base=0.0)
    skips, gs = [rn(b, hs, wd, co) for _ in range(2)], [rn(b, hs, wd, co) for _ in range(2)]

    def run(lo, hi, plain=False):
        xs_ = [t[lo:hi].detach().requires_grad_(True) for t in xs]
        sk = [t[lo:hi] for t in skips]
        if plain:
            outs = conv_spmd.conv3x3_shards_plain(xs_, w, bias, A[lo:hi], B[lo:hi], sk)
        else:
            outs = conv_spmd.conv3x3_gn_silu_add(xs_, A[lo:hi], B[lo:hi], w, bias, sk)
        dxs = torch.autograd.grad(outs, xs_, [t[lo:hi] for t in gs])
        return torch.cat(outs, 1).detach(), torch.cat(dxs, 1)

    got = run(0, b)
    for a, r in zip(got, run(0, b, plain=True)):
        _close(a, r, dtype)
    # the forward's K-halo and the backward's (on the cotangent, Cout -> Cin)
    same = all(_ksplit(dtype, 1, hs, wd, i, o, halo=True) == _ksplit(dtype, b, hs, wd, i, o,
                                                                      halo=True)
               for i, o in ((ci, co), (co, ci)))
    _per_image(got, [run(i, i + 1) for i in range(b)], same, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [2, 4, 8])
@pytest.mark.parametrize("heads,t,d", [(8, 1024, 64), (4, 256, 192), (4, 64, 256)])
def test_attention_at_n_b_times_heads(dev, dtype, b, heads, t, d):
    rn = _rn(dev, dtype, 4)
    qkv, g = rn(b, t, 3 * heads * d), rn(b, t, heads * d)

    def call(lo, hi):
        out, lse = kattn.attention_fwd(qkv[lo:hi], heads)
        return out, kattn.attention_bwd(qkv[lo:hi], out, lse, g[lo:hi], heads)

    out, dqkv = call(0, b)
    q, k, v = kattn.split_heads(qkv, heads)
    _close(out, kattn.merge_heads(kattn.attention_fwd_plain(q, k, v), b), dtype)
    for a, r in zip(dqkv.chunk(3, dim=-1),
                    kattn.attention_bwd_plain(q, k, v, kattn.to_heads(g, heads))):
        _close(a, kattn.merge_heads(r, b), dtype)
    _per_image((out, dqkv), [call(i, i + 1) for i in range(b)], True, dtype)
