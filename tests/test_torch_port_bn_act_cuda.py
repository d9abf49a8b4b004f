"""K-bn on a card (``csrc/bn_act.cu`` through ``kernels/bn_act.py``), held
bit for bit to its plain version (``bn_act_plain``, the f32-island chain)
run on the same card: forward, and the input gradients of the autograd
Function against autograd's of the chain, at bf16 and f32, at every site
shape of CLIP RN50x16's ResNet tower at 16 cutouts of 384^2 (192^2 ... 12^2,
48 ... 3072 channels), in the layouts the tower hands it (channels last;
the stem's NHWC view of an NCHW tensor) and in the kernel's other paths (a
channel count that is not a multiple of the vector, a pointer off 16
bytes); reruns are bit-identical. A guided RN50x16 step through the API
launches K-bn 123 times each way (83 in mode "a", 36 in "b", 4 in "c"),
graph replays included; a ViT-B/32 step launches it never.

Marked ``cuda``; imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_bn_act_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from cgd_tpu_torch.kernels import bn_act as kbn  # noqa: E402

pytestmark = pytest.mark.cuda

B = 16  # cutouts
# (H, C, mode) of every BatchNorm site of RN50x16 at 384^2: the stem at 192^2,
# then each stage's first block (bn1, bn2 at the input's size, bn3 with the
# down projection after the pool) and its other blocks
SITES = [(192, 48, "a"), (192, 96, "a"),
         (96, 96, "a"), (96, 384, "c"), (96, 384, "b"),
         (96, 192, "a"), (48, 768, "c"), (48, 192, "a"), (48, 768, "b"),
         (48, 384, "a"), (24, 1536, "c"), (24, 384, "a"), (24, 1536, "b"),
         (24, 768, "a"), (12, 3072, "c"), (12, 768, "a"), (12, 3072, "b")]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _inputs(dev, shape, dtype, mode, seed=0):
    """Activations, factors and a cotangent on the card, with zeros that make
    x*s + b = +0 and -0, a negative scale and infinities planted."""
    gen = torch.Generator(dev).manual_seed(seed)
    c = shape[-1]

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    x = rn(*shape, scale=2.0).to(dtype)
    s, b = rn(c), rn(c, scale=0.5)
    x[..., :2] = 0
    s[:2] = -1.0
    b[0], b[1] = 0.0, -0.0
    x.view(-1, c)[0, 2] = float("inf")
    x.view(-1, c)[-1, 3] = float("-inf")
    r = rn(*shape).to(dtype) if mode != "a" else None
    sd, bd = (rn(c), rn(c, scale=0.5)) if mode == "c" else (None, None)
    dy = rn(*shape).to(dtype)
    return x, s, b, r, sd, bd, dy


def _run(fn, x, s, b, r, sd, bd, dy):
    xg = x.detach().requires_grad_(True)  # x's storage: its layout and offset kept
    rg = None if r is None else r.detach().requires_grad_(True)
    y = fn(xg, s, b, rg, sd, bd)
    y.backward(dy)
    return y.detach(), xg.grad, None if rg is None else rg.grad


def _check(args, mode):
    kbn.reset_launch_counts()
    got = _run(kbn.bn_act, *args)
    assert got[0].stride() == args[0].stride()  # y in x's layout
    assert kbn.LAUNCHES[f"bn_act_fwd_{mode}"] == kbn.LAUNCHES[f"bn_act_bwd_{mode}"] == 1
    want = _run(kbn.bn_act_plain, *args)
    for g, w in zip(got, want):
        if w is not None:
            _same(g, w)
    again = _run(kbn.bn_act, *args)
    for g, a in zip(got, again):
        if a is not None:
            assert torch.equal(_bits(g), _bits(a))


@pytest.mark.parametrize("site", SITES, ids=[f"{h}x{c}{m}" for h, c, m in SITES])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_kbn_is_bit_equal_to_the_chain_at_every_site(dev, site, dtype):
    h, c, mode = site
    _check(_inputs(dev, (B, h, h, c), dtype, mode), mode)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [48, 96])
def test_kbn_on_the_stems_channel_major_layout(dev, dtype, c):
    """An NHWC view of an NCHW tensor, as the stem's convs leave it: the
    plane path, the output in the input's layout."""
    x, s, b, _, _, _, dy = _inputs(dev, (B, 192, 192, c), dtype, "a", seed=1)
    x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    dy = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    _check((x, s, b, None, None, None, dy), "a")


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", ["a", "b", "c"])
@pytest.mark.parametrize("case", ["c20", "offset", "mixed-layouts"])
def test_kbn_off_the_vector_path(dev, dtype, mode, case):
    """A channel count that is not a multiple of the vector, a tensor whose
    first element is off a 16-byte boundary, and an identity and cotangent
    in another layout than x's: the same bits as the chain."""
    c = 20 if case == "c20" else 64
    x, s, b, r, sd, bd, dy = _inputs(dev, (3, 7, 9, c), dtype, mode, seed=2)
    if case == "offset":
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
        assert x.data_ptr() % 16
    if case == "mixed-layouts":
        dy = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        if r is not None:
            r = r.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    _check((x, s, b, r, sd, bd, dy), mode)


def test_relu_of_a_nan_and_of_signed_zeros_as_pytorch(dev):
    """clamp_min's NaN and zero rules at bf16 and f32: NaN where the chain
    has NaN, every other bit the chain's."""
    for dtype in DTYPES:
        x = torch.tensor([[0.0, -0.0, float("nan"), 1.0, -1.0, float("inf"), 3.0, -2.0]],
                         device=dev).to(dtype)
        s = torch.tensor([1.0, -1.0, 1.0, 0.0, -0.0, 1.0, float("nan"), 1.0], device=dev)
        b = torch.tensor([-0.0, -0.0, 0.0, -0.0, -0.0, 0.0, 0.0, 2.0], device=dev)
        got, want = kbn.bn_act_fwd(x, s, b), kbn.bn_act_plain(x, s, b)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_the_rn50x16_tower_on_kbn_is_bit_equal_to_the_plain_chain(dev, layout):
    """The whole image tower at bf16 (random weights, its BatchNorms drawn
    away from the unit init): embeddings and the cutouts' gradient on the
    kernel route equal those under kernel_routing("plain"), bit for bit;
    K-bn is the only difference between the two routes in the tower."""
    from cgd_tpu_torch.models.clip.configs import CLIP_CONFIGS
    from cgd_tpu_torch.models.clip.model import CLIP, encode_image
    from cgd_tpu_torch.models.unet import Norm
    from cgd_tpu_torch.ops import nn as cnn

    gen = torch.Generator(dev).manual_seed(3)
    model = CLIP(CLIP_CONFIGS["RN50x16"], device=dev).init_weights(gen)
    with torch.no_grad():
        for m in model.visual.modules():
            if isinstance(m, Norm):
                m.scale.copy_(1 + 0.2 * torch.randn(m.scale.shape, generator=gen, device=dev))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen, device=dev))
    cnn.cast_conv_params(model.visual, torch.bfloat16)
    cuts = torch.randn(B, 384, 384, 3, generator=gen, device=dev)
    if layout == "nchw":
        cuts = cuts.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    def run():
        c = cuts.detach().requires_grad_(True)
        e = encode_image(model, c, compute_dtype=torch.bfloat16)
        (e * torch.linspace(-1, 1, e.shape[-1], device=dev)).sum().backward()
        return e.detach(), c.grad

    kbn.reset_launch_counts()
    kernel = run()
    assert kbn.LAUNCHES == {"bn_act_fwd_a": 83, "bn_act_fwd_b": 36, "bn_act_fwd_c": 4,
                            "bn_act_bwd_a": 83, "bn_act_bwd_b": 36, "bn_act_bwd_c": 4}
    with cnn.kernel_routing("plain"):
        plain = run()
    for k, p in zip(kernel, plain):
        assert torch.isfinite(p).all()
        assert torch.equal(k, p)


def _api_step_counts(dev, tmp_path, monkeypatch, **kw):
    """Run a short API call; return (guided steps, replayed steps, K-bn's
    launch counts)."""
    from cgd_tpu_torch import api
    from cgd_tpu_torch.kernels import launch_counters
    from cgd_tpu_torch.utils import tracing

    monkeypatch.chdir(tmp_path)
    for cnt in launch_counters():
        for k in cnt:
            cnt[k] = 0
    tracing.take()
    tracing.enable()
    try:
        for _ in api.clip_guided_diffusion(prompts=["a lighthouse in a storm"],
                                           weights_mode="random", seed=1234567891,
                                           device=str(dev), progress=False,
                                           prefix_path=tmp_path / "run", **kw):
            pass
    finally:
        tracing.disable()
        steps = [s for s in tracing.take() if s.name == "step"]
    torch.cuda.synchronize(dev)
    guided = sum(s.counts["guided"] for s in steps)
    replayed = sum(s.counts["graph"] for s in steps)
    return guided, replayed, dict(kbn.LAUNCHES)


def test_a_guided_rn50x16_step_launches_kbn_123_times_each_way(dev, tmp_path, monkeypatch):
    guided, replayed, counts = _api_step_counts(
        dev, tmp_path, monkeypatch, image_size=512, class_cond=True, num_cutouts=16,
        clip_model_name="RN50x16", timestep_respacing="ddim4", save_frequency=4)
    assert guided == 4 and replayed >= 2
    per_step = {"a": 83, "b": 36, "c": 4}
    assert counts == {f"bn_act_{w}_{m}": guided * n for w in ("fwd", "bwd")
                      for m, n in per_step.items()}


def test_a_vit_step_launches_no_kbn(dev, tmp_path, monkeypatch):
    guided, _, counts = _api_step_counts(
        dev, tmp_path, monkeypatch, image_size=256, num_cutouts=16,
        clip_model_name="ViT-B/32", timestep_respacing="ddim3", save_frequency=3)
    assert guided == 3
    assert not any(counts.values())


def test_the_plain_route_launches_no_kbn(dev):
    from cgd_tpu_torch.ops import nn as cnn

    x, s, b, _, _, _, _ = _inputs(dev, (2, 8, 8, 64), torch.bfloat16, "a")

    class P:
        scale, bias = s, b

    kbn.reset_launch_counts()
    with cnn.kernel_routing("plain"):
        y = cnn.bn_relu(P, x)
    _same(y, F.relu((x.float() * s + b).to(x.dtype)))
    assert not any(kbn.LAUNCHES.values())
