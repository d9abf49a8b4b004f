"""K-bn's plain versions on the CPU (``cgd_tpu_torch/kernels/bn_act.py``):
the CLIP ResNet's folded BatchNorm -> [residual add] -> ReLU, in its three
modes, held bit for bit to the f32-island chain the tower ran before it
(written out here: ``x.float() * scale + bias``, cast back, the bf16 add,
``F.relu``), forward and autograd's input gradients, at bf16 and f32, at
the tower's channel counts and at one that is not a multiple of 8. The
autograd Function's plain route (its backward written out, not autograd's)
is held to the same bits, and so is the routing op the tower calls.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from cgd_tpu_torch.kernels import bn_act as kbn  # noqa: E402
from cgd_tpu_torch.ops import nn as cnn  # noqa: E402

torch.set_num_threads(2)

# the RN50x16 tower's widths (48 ... 3072), RN50's 32 and 64, and one that
# is not a multiple of 8
CHANNELS = [48, 96, 192, 384, 768, 1536, 3072, 32, 20]
DTYPES = [torch.bfloat16, torch.float32]
MODES = ["a", "b", "c"]


def _chain(x, s, b, r=None, sd=None, bd=None):
    """The chain the tower ran before K-bn: the folded BatchNorm in an f32
    island, cast back, the residual add and F.relu."""
    out = (x.float() * s + b).to(x.dtype)
    if r is not None:
        if sd is not None:
            r = (r.float() * sd + bd).to(r.dtype)
        out = out + r
    return F.relu(out)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _inputs(c, dtype, mode, seed=0, shape=(2, 3, 3)):
    """x, the factors, the identity / down input and a cotangent, with
    edge values planted: zeros that make x*s + b = +0 and -0, a negative
    scale, infinities, and a NaN."""
    gen = torch.Generator().manual_seed(seed * 7 + c)
    x = (torch.randn(*shape, c, generator=gen) * 2).to(dtype)
    s = torch.randn(c, generator=gen)
    b = torch.randn(c, generator=gen) * 0.5
    x[..., :2] = 0
    s[:2] = -1.0
    b[0], b[1] = 0.0, -0.0
    x[0, 0, 0, 2] = float("inf")
    x[0, 0, 1, 3] = float("-inf")
    x[1, 2, 2, 4] = float("nan")
    r = sd = bd = None
    if mode != "a":
        r = torch.randn(*shape, c, generator=gen).to(dtype)
        r[1, 0, 0, 5] = -x[1, 0, 0, 5]  # may cancel to an exact zero
    if mode == "c":
        sd = torch.randn(c, generator=gen)
        bd = torch.randn(c, generator=gen) * 0.5
    dy = torch.randn(*shape, c, generator=gen).to(dtype)
    dy[0, 1, 1, :3] = -0.0
    return x, s, b, r, sd, bd, dy


def _grads(fn, x, s, b, r, sd, bd, dy):
    xg = x.clone().requires_grad_(True)
    rg = None if r is None else r.clone().requires_grad_(True)
    y = fn(xg, s, b, rg, sd, bd)
    y.backward(dy)
    return y.detach(), xg.grad, None if rg is None else rg.grad


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_is_the_chain_forward_and_backward(c, dtype, mode):
    args = _inputs(c, dtype, mode)
    for got, want in zip(_grads(kbn.bn_act_plain, *args), _grads(_chain, *args)):
        if want is not None:
            _same(got, want)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_function_plain_route_is_bit_equal_to_the_chain(c, dtype, mode):
    """The autograd Function on CPU tensors: forward the plain chain,
    backward ``bn_act_bwd_plain`` (threshold, then T(g*s), and the
    identity's g or T(g*sd)), each bit-equal to autograd's."""
    args = _inputs(c, dtype, mode, seed=1)
    got, want = _grads(kbn.bn_act, *args), _grads(_chain, *args)
    _same(got[0], want[0])
    _same(got[1], want[1])
    if mode == "a":
        assert got[2] is None
    else:
        _same(got[2], want[2])


@pytest.mark.parametrize("mode", MODES)
def test_backward_plain_reads_y_alone(mode):
    """bn_act_bwd_plain from the saved output, as the kernel does: the same
    gradients as autograd's backward of the chain."""
    x, s, b, r, sd, bd, dy = _inputs(96, torch.bfloat16, mode, seed=2)
    y, dx, dr = _grads(_chain, x, s, b, r, sd, bd, dy)
    got_dx, got_dr = kbn.bn_act_bwd_plain(y, dy, s, mode, sd)
    _same(got_dx, dx)
    if mode == "a":
        assert got_dr is None
    else:
        _same(got_dr, dr)


@pytest.mark.parametrize("mode", MODES)
def test_routing_op_takes_the_plain_chain_on_the_cpu(mode):
    """ops.nn.bn_relu, as the tower calls it with a Norm-like module: on a
    CPU tensor and under kernel_routing("plain") the chain's bits, and no
    kernel launch counted."""
    x, s, b, r, sd, bd, _ = _inputs(192, torch.bfloat16, mode, seed=3)

    class P:
        scale, bias = s, b

    class D:
        scale, bias = sd, bd

    kbn.reset_launch_counts()
    want = _chain(x, s, b, r, sd, bd)
    _same(cnn.bn_relu(P, x, r, D if mode == "c" else None), want)
    with cnn.kernel_routing("plain"):
        _same(cnn.bn_relu(P, x, r, D if mode == "c" else None), want)
    assert not any(kbn.LAUNCHES.values())


def test_channel_major_layout_keeps_its_strides():
    """An NHWC view of an NCHW tensor (the stem's first conv output): the
    Function's plain route gives the chain's bits in the same layout."""
    x, s, b, _, _, _, dy = _inputs(48, torch.bfloat16, "a", seed=4, shape=(2, 5, 5))
    x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    got, want = _grads(kbn.bn_act, x, s, b, None, None, None, dy), \
        _grads(_chain, x, s, b, None, None, None, dy)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert got[0].stride() == want[0].stride() == x.stride()


def test_factors_with_gradients_are_refused():
    x, s, b, _, _, _, _ = _inputs(48, torch.float32, "a")
    with pytest.raises(ValueError, match="constants"):
        kbn.bn_act(x, s.clone().requires_grad_(True), b)


def test_launch_counters_include_kbn():
    from cgd_tpu_torch.kernels import launch_counters

    assert any(c is kbn.LAUNCHES for c in launch_counters())
    assert sorted(kbn.LAUNCHES) == sorted(f"bn_act_{w}_{m}" for w in ("fwd", "bwd")
                                          for m in MODES)


def test_bench_counts_each_array_once():
    """chip_smoke.py's bound of K-bn (phase 3): forward reads x (and the
    identity) and writes y; backward reads y and dy and writes dx (and the
    identity's gradient)."""
    from chip_smoke import bn_act_bytes as pass_bytes

    n = 16 * 96 * 96 * 384
    assert pass_bytes(n, 2, "a", False) == 4 * n
    assert pass_bytes(n, 2, "b", False) == pass_bytes(n, 2, "c", False) == 6 * n
    assert pass_bytes(n, 2, "a", True) == 6 * n
    assert pass_bytes(n, 4, "b", True) == 16 * n
