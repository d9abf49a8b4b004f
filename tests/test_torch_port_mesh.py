"""The port's height-split mesh path against cgd_tpu's on the CPU, at toy size.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port on a
mesh of repeated CPU devices (``make_mesh([cpu] * n)``: one process, shards
one after the other). Inputs are drawn with numpy and handed to both.

- the ``--mesh`` grammar: the same mesh shapes and the same ``ValueError``s;
- K-halo's plain version against ``_conv3x3_pallas(..., etop=, ebot=)`` in
  Pallas interpret mode (atol 2e-4, tests/test_pallas_conv.py's bound);
- K-halo at f32 on the shard shapes the f32 kernel must handle (shorter
  than its 8-row patch, ragged heights and widths, Cin 3) against what the
  JAX mesh path runs there, ``conv_spmd._xla_reference`` (the Pallas kernel
  has no VMEM plan for such shards; atol 2e-5, f32 sums in another order);
- the split conv family against ``cgd_tpu.kernels.conv_spmd`` on height- and
  batch+height-sharded meshes, forward, input and weight gradients (atol
  1e-5, and 1e-4 of the largest value for the gradients: f32, the halo and
  shard sums in another order);
- the split toy UNet against JAX's spatially sharded ``apply_unet`` under
  ``conv_routing("spmd")``, forward (atol 2e-5, tests/test_parallel.py's
  bound) and input gradient (atol 1e-5 of the largest value);
- one guided step on a cut=2 mesh against JAX's guided step with ``mesh=``
  (tests/test_torch_port_step.py's harness and tolerance);
- the API with ``mesh=make_mesh([cpu, cpu])`` and the CLI's ``--mesh``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from test_torch_port_step import CUTN, SIZE, _close, _draws, _pair, models  # noqa: E402,F401

from cgd_tpu.diffusion import sampler as jsampler  # noqa: E402
from cgd_tpu.kernels import conv_spmd as jspmd  # noqa: E402
from cgd_tpu.kernels.conv_pallas import _conv3x3_pallas  # noqa: E402
from cgd_tpu.models import unet as junet  # noqa: E402
from cgd_tpu.ops.nn import conv_routing  # noqa: E402
from cgd_tpu.parallel import mesh as jmesh  # noqa: E402
from cgd_tpu_torch import api as tapi  # noqa: E402
from cgd_tpu_torch import cli as tcli  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.diffusion import sampler as tsampler  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402
from cgd_tpu_torch.kernels import conv_spmd as tspmd  # noqa: E402
from cgd_tpu_torch.models import unet as tunet  # noqa: E402
from cgd_tpu_torch.ops.nn import kernel_routing  # noqa: E402
from cgd_tpu_torch.parallel import mesh as tmesh  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _outcome(fn, *args):
    try:
        m = fn(*args)
    except ValueError as e:
        return "ValueError", str(e)
    return None if m is None else dict(zip(m.axis_names, m.devices.shape))


@pytest.mark.parametrize("spec,n_dev", [
    ("auto", 8), ("auto", 1), (None, 8), ("", 8), ("data=2", 8), ("data=2,cut=2", 8),
    ("cut=4", 8), ("data=3", 8), ("foo=2", 8), ("data=0", 8), ("data=2,cut=8", 8), ("data", 8),
])
def test_mesh_from_spec_matches_jax(spec, n_dev):
    want = _outcome(jmesh.mesh_from_spec, spec, jax.devices()[:n_dev])
    got = _outcome(tmesh.mesh_from_spec, spec, [CPU] * n_dev)
    assert got == want
    if spec in ("data=3", "foo=2", "data=0", "data=2,cut=8", "data"):
        assert got[0] == "ValueError"


def test_mesh_places_replicas_and_splits_top_to_bottom():
    mesh = tmesh.make_mesh([CPU] * 4, data=2)
    assert mesh.shape == {"data": 2, "cut": 2} and mesh.size == 4 and mesh.main == CPU
    assert mesh.distinct_devices() == [CPU]
    lin = torch.nn.Linear(3, 3)
    assert tmesh.shard_params_replicated(lin, mesh) == {CPU: lin}  # shared, not copied
    x = torch.arange(4 * 8 * 2 * 1.0).reshape(4, 8, 2, 1)
    s = tmesh.split_activation(x, mesh)
    assert s.shape == (4, 8, 2, 1)
    assert torch.equal(s.shards[1][0], x[2:, :4]) and torch.equal(s.shards[0][1], x[:2, 4:])
    assert torch.equal(s.gather(), x)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.split_activation(x[:, :7], mesh)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("variant,cin", [("plain", 128), ("prologue", 128), ("skip", 128),
                                         ("plain", 3)])
def test_khalo_plain_matches_pallas_explicit_halo(variant, cin):
    """An interior shard: rows [1, 33) of a 34-row image with its true
    neighbour rows (post-activation for the prologue) as the halo."""
    b, hh, w, co = 1, 34, 32, 128
    x_full = _rand((b, hh, w, cin), 50)
    wk, bias = _rand((3, 3, cin, co), 51, 0.05), _rand((co,), 52)
    skip = _rand((b, hh - 2, w, co), 55) if variant == "skip" else None
    A = B = None
    rows = x_full
    if variant != "plain":
        A, B = 1.0 + 0.1 * _rand((b, cin), 53), 0.1 * _rand((b, cin), 54)
        pre = x_full * A[:, None, None, :] + B[:, None, None, :]
        rows = pre / (1.0 + np.exp(-pre))
    etop, ebot = rows[:, :1], rows[:, -1:]
    with pltpu.force_tpu_interpret_mode():
        ref = _conv3x3_pallas(
            jnp.asarray(x_full[:, 1:-1]), jnp.asarray(wk), jnp.asarray(bias),
            A=None if A is None else jnp.asarray(A), B=None if B is None else jnp.asarray(B),
            skip=None if skip is None else jnp.asarray(skip),
            etop=jnp.asarray(etop), ebot=jnp.asarray(ebot))
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in dict(x=x_full[:, 1:-1], w=wk, b=bias, A=A, B=B, s=skip, et=etop,
                          eb=ebot).items()}
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(t["x"], t["w"], t["b"], t["A"], t["B"], t["s"], etop=t["et"],
                         ebot=t["eb"])
    assert sum(k3.LAUNCHES.values()) == 0  # the CPU takes the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="etop and ebot"):
        k3.conv3x3_fwd(t["x"], t["w"], t["b"], etop=t["et"])


# K-halo f32 shards (batch, shard H, W, Cin, Cout): a 4-row shard (the 8^2
# level at cut=2), a 12-row shard 24 wide, a 2-row shard (8^2 at cut=4),
# and conv_in's Cin 3
F32_HALO = [(1, 4, 16, 64, 64), (2, 12, 24, 64, 96), (1, 2, 8, 128, 64), (1, 8, 16, 3, 32)]


@pytest.mark.parametrize("shape", F32_HALO, ids=["4row", "12x24", "2row", "cin3"])
@pytest.mark.parametrize("variant", ["plain", "prologue", "prologue_skip"])
def test_khalo_f32_plain_matches_the_jax_mesh_reference(shape, variant):
    """The port's f32 K-halo (its plain version on the CPU) against
    ``_xla_reference``, the conv the JAX mesh path runs on a shard the Pallas
    kernel cannot plan: the same x, weights, A / B, skip and neighbour rows
    (post-activation for the prologue variants)."""
    b, h, w, ci, co = shape
    seed = 60 + 10 * F32_HALO.index(shape)
    x, wk, bias = _rand((b, h, w, ci), seed), _rand((3, 3, ci, co), seed + 1, 0.1), \
        _rand((co,), seed + 2)
    rows = _rand((b, 2, w, ci), seed + 3)
    A = B = skip = None
    if variant != "plain":
        A, B = 1.0 + 0.1 * _rand((b, ci), seed + 4), 0.1 * _rand((b, ci), seed + 5)
        pre = rows * A[:, None, None, :] + B[:, None, None, :]
        rows = (pre / (1.0 + np.exp(-pre))).astype(np.float32)
    if variant == "prologue_skip":
        skip = _rand((b, h, w, co), seed + 6)
    etop, ebot = rows[:, :1], rows[:, 1:]
    args = dict(x=x, w=wk, bias=bias, A=A, B=B, skip=skip, etop=etop, ebot=ebot)
    ref = jspmd._xla_reference(*(None if v is None else jnp.asarray(v) for v in args.values()))
    t = {k: None if v is None else torch.from_numpy(v) for k, v in args.items()}
    k3.reset_launch_counts()
    out = k3.conv3x3_fwd(t["x"], t["w"], t["bias"], t["A"], t["B"], t["skip"], etop=t["etop"],
                         ebot=t["ebot"])
    assert not any(k3.LAUNCHES.values())  # the CPU takes the plain version
    assert out.dtype == torch.float32 and out.shape == (b, h, w, co)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def conv_ops():
    b, h, w, ci, co = 2, 32, 16, 64, 64
    return dict(x=_rand((b, h, w, ci), 0), w=_rand((3, 3, ci, co), 1, 0.05), bias=_rand((co,), 2),
                A=1.0 + 0.1 * _rand((b, ci), 3), B=0.1 * _rand((b, ci), 4),
                skip=_rand((b, h, w, co), 5), probe=_rand((b, h, w, co), 6))


@pytest.mark.parametrize("variant", ["plain", "gn", "gn_add"])
@pytest.mark.parametrize("data,cut", [(1, 2), (1, 4), (2, 2), (2, 4)],
                         ids=["height2", "height4", "batch+height2", "batch+height4"])
def test_split_conv_family_matches_conv_spmd(conv_ops, variant, data, cut):
    o = conv_ops
    jm = jmesh.make_mesh(jax.devices()[:data * cut], data=data)
    spec = NamedSharding(jm, P("data" if data > 1 else None, "cut", None, None))
    jb, jA, jB = (jnp.asarray(o[k]) for k in ("bias", "A", "B"))

    def jfn(x, jw, skip):
        if variant == "plain":
            return jspmd.conv3x3(x, jw, jb)
        if variant == "gn":
            return jspmd.conv3x3_gn_silu(x, jA, jB, jw, jb)
        return jspmd.conv3x3_gn_silu_add(x, jA, jB, jw, jb, skip)

    def jloss(x, jw, skip):
        out = jfn(x, jw, skip)
        return jnp.sum(jnp.sin(out) * o["probe"]), out

    xs = jax.device_put(jnp.asarray(o["x"]), spec)
    ss = jax.device_put(jnp.asarray(o["skip"]), spec)
    (_, ref), grefs = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
        xs, jnp.asarray(o["w"]), ss)

    tm = tmesh.make_mesh([CPU] * (data * cut), data=data)
    x = torch.from_numpy(o["x"]).requires_grad_(True)
    sx = tmesh.split_activation(x, tm)
    sk = tmesh.split_activation(torch.from_numpy(o["skip"]), tm)
    w = torch.from_numpy(o["w"]).requires_grad_(True)
    bias = torch.from_numpy(o["bias"])
    rows = []
    for d, row in enumerate(sx.shards):
        A, B = (sx.rows(torch.from_numpy(o[k]), d) for k in ("A", "B"))
        if variant == "plain":
            rows.append(tspmd.conv3x3(row, w, bias))
        elif variant == "gn":
            rows.append(tspmd.conv3x3_gn_silu(row, A, B, w, bias))
        else:
            rows.append(tspmd.conv3x3_gn_silu_add(row, A, B, w, bias, sk.shards[d]))
    out = tmesh.Split(rows, tm).gather()
    (torch.sin(out) * torch.from_numpy(o["probe"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    for got, gref in zip((x.grad, w.grad), grefs):
        g = np.asarray(gref)
        np.testing.assert_allclose(got.numpy(), g, atol=1e-4 * float(np.abs(g).max()), rtol=1e-4)


def test_split_unet_matches_jax_spatially_sharded_unet():
    """tests/test_parallel.py's height-sharded toy UNet (data=2, cut=4 over
    the 8 devices) under conv_routing("spmd"), against the port's UNet on a
    Split over the same mesh shape."""
    cfg_kw = dict(image_size=32, model_channels=64, num_res_blocks=1, attention_ds=(4,),
                  channel_mult=(1, 2), num_head_channels=16)
    jcfg = junet.UNetConfig(**cfg_kw)
    params = junet.init_unet(jax.random.PRNGKey(0), jcfg)
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(7)
    params = jax.tree.unflatten(
        treedef, [jnp.asarray(np.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32))
                  for l in leaves])
    x = _rand((2, 32, 32, 3), 8)
    t = np.array([3.0, 9.0], np.float32)
    probe = _rand((2, 32, 32, 6), 9)
    jm = jmesh.make_mesh(data=2)

    def jloss(x_):
        x_ = jax.lax.with_sharding_constraint(x_, jmesh.spatial_sharding(jm))
        out = junet.apply_unet(params, jcfg, x_, jnp.asarray(t))
        return jnp.sum(jnp.sin(out) * probe), out

    with conv_routing("spmd"):
        (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))

    model = load_from_jax(tunet.UNet(tunet.UNetConfig(**cfg_kw)), params)
    tm = tmesh.make_mesh([CPU] * 8, data=2)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(tmesh.split_activation(xt, tm), torch.from_numpy(t))
    assert isinstance(out, tmesh.Split) and out.shape == (2, 32, 32, 6)
    out = out.gather()
    (torch.sin(out) * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)
    g = np.asarray(gref)
    np.testing.assert_allclose(xt.grad.numpy(), g, atol=1e-5 * float(np.abs(g).max()))


@pytest.mark.parametrize("route", [None, "plain"])
def test_split_unet_with_conv_resample_layers_matches_unsplit(route):
    """resblock_updown=False: the stride-2 downsample conv runs on the
    gathered image, the upsample's conv on the halo path; split cut=2 against
    the same UNet unsplit (f32, atol 1e-5 of the largest value)."""
    cfg = tunet.UNetConfig(image_size=16, model_channels=32, num_res_blocks=1, attention_ds=(),
                           channel_mult=(1, 2), num_head_channels=16, resblock_updown=False)
    model = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.from_numpy(_rand(tuple(p.shape), 10)))
    x, t = torch.from_numpy(_rand((1, 16, 16, 3), 11)), torch.tensor([5.0])
    mesh = tmesh.make_mesh([CPU, CPU])
    res = []
    with kernel_routing(route):
        for split in (False, True):
            x_ = x.clone().requires_grad_(True)
            out = model(tmesh.split_activation(x_, mesh) if split else x_, t)
            out = out.gather() if split else out
            res.append((out.detach(), torch.autograd.grad(out.square().sum(), x_)[0]))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-5 * float(want.abs().max()))


def test_split_unet_refuses_a_level_that_does_not_divide():
    """Only the input's own height must divide by 'cut': split_activation
    refuses it otherwise (the API then runs the UNet whole). A level below
    it that the cut does not divide runs whole inside the split UNet (24px
    at cut=4: level 2 is 6x6), and the output comes back split."""
    cfg = tunet.UNetConfig(image_size=32, model_channels=32, num_res_blocks=1, attention_ds=(),
                           channel_mult=(1, 2, 2, 2), num_head_channels=16)
    model = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    mesh = tmesh.make_mesh([CPU] * 4)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.split_activation(torch.zeros(1, 26, 26, 3), mesh)
    out = model(tmesh.split_activation(torch.zeros(1, 24, 24, 3), mesh), torch.tensor([1.0]))
    assert isinstance(out, tmesh.Split) and out.shape == (1, 24, 24, 6)


# a 24px toy UNet at cut=4: levels 24 and 12 divide, 6 and 3 do not
_UNEVEN =dict(image_size=32, model_channels=32, num_res_blocks=1, attention_ds=(4,),
               channel_mult=(1, 2, 2, 2), num_head_channels=16)


def _uneven_params():
    params = junet.init_unet(jax.random.PRNGKey(0), junet.UNetConfig(**_UNEVEN))
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(7)
    return jax.tree.unflatten(
        treedef, [jnp.asarray(np.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32))
                  for l in leaves])


@pytest.mark.parametrize("route", [None, "plain"])
def test_split_unet_at_levels_the_cut_does_not_divide_matches_unsplit(route):
    """The 6^2 and 3^2 levels under cut=4 run whole (the downsample gathers,
    the skip connection splits again), the 24^2 and 12^2 ones split: forward
    and input gradient against the same UNet unsplit (f32, atol 1e-5 of the
    largest value)."""
    model = load_from_jax(tunet.UNet(tunet.UNetConfig(**_UNEVEN)), _uneven_params())
    x, t = torch.from_numpy(_rand((1, 24, 24, 3), 8)), torch.tensor([3.0])
    mesh = tmesh.make_mesh([CPU] * 4)
    res = []
    with kernel_routing(route):
        for split in (False, True):
            x_ = x.clone().requires_grad_(True)
            out = model(tmesh.split_activation(x_, mesh) if split else x_, t)
            assert isinstance(out, tmesh.Split) == split
            out = out.gather() if split else out
            res.append((out.detach(), torch.autograd.grad(out.square().sum(), x_)[0]))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-5 * float(want.abs().max()))


def test_split_unet_at_levels_the_cut_does_not_divide_matches_jax():
    """cgd_tpu runs the same UNet spatially sharded at cut=4 under
    conv_routing("spmd") (GSPMD pads the 6^2 and 3^2 levels' shards); the
    port's split UNet against it, forward (atol 2e-5) and input gradient
    (atol 1e-5 of the largest value), as the even split's test."""
    params = _uneven_params()
    jcfg = junet.UNetConfig(**_UNEVEN)
    x = _rand((1, 24, 24, 3), 8)
    t = np.array([3.0], np.float32)
    probe = _rand((1, 24, 24, 6), 9)
    jm = jmesh.make_mesh(jax.devices()[:4])

    def jloss(x_):
        x_ = jax.lax.with_sharding_constraint(x_, jmesh.spatial_sharding(jm))
        out = junet.apply_unet(params, jcfg, x_, jnp.asarray(t))
        return jnp.sum(jnp.sin(out) * probe), out

    with conv_routing("spmd"):
        (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))

    model = load_from_jax(tunet.UNet(tunet.UNetConfig(**_UNEVEN)), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(tmesh.split_activation(xt, tmesh.make_mesh([CPU] * 4)), torch.from_numpy(t))
    out = out.gather()
    (torch.sin(out) * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)
    g = np.asarray(gref)
    np.testing.assert_allclose(xt.grad.numpy(), g, atol=1e-5 * float(np.abs(g).max()))


def test_a_stride_two_downsample_into_a_level_the_cut_does_not_divide_runs_whole():
    """resblock_updown=False: the stride-2 conv's output (6 rows at cut=4)
    comes back whole from the gathered conv, and the upsample path splits
    it again at the skip connection; split against unsplit."""
    cfg = tunet.UNetConfig(image_size=16, model_channels=32, num_res_blocks=1, attention_ds=(),
                           channel_mult=(1, 2), num_head_channels=16, resblock_updown=False)
    model = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.from_numpy(_rand(tuple(p.shape), 10)))
    x, t = torch.from_numpy(_rand((1, 12, 12, 3), 11)), torch.tensor([5.0])
    mesh = tmesh.make_mesh([CPU] * 4)
    want = model(x, t)
    got = model(tmesh.split_activation(x, mesh), t).gather()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-5 * float(want.abs().max()))


def test_one_guided_step_on_a_mesh_matches_jax(models):
    """One guided DDIM step, the UNet split cut=2 and the cutouts split over
    both devices, against JAX's guided step with mesh= on two devices."""
    from cgd_tpu.guidance import pipeline as jpipe
    from cgd_tpu.guidance.cutouts import CutoutSpec as JSpec
    from cgd_tpu_torch.guidance import pipeline as tpipe
    from cgd_tpu_torch.guidance.cutouts import CutoutSpec as TSpec

    d = _draws(1, seed=5)
    jdiff, _, jcfg, jmodel, tdiff, _, tcfg, tmodel = _pair(models, d, "ddim25", True)
    settings = dict(clip_guidance_scale=1000.0, tv_scale=150.0, range_scale=50.0,
                    sat_scale=10.0, clip_compute_dtype="float32")
    jm = jmesh.make_mesh(jax.devices()[:2])
    tm = tmesh.make_mesh([CPU, CPU])
    jb = jpipe.make_guidance_builder(
        models["jccfg"], d["targets"], d["weights"], jdiff, jpipe.GuidanceSettings(**settings),
        cached_coords=JSpec(*d["coords"]), mesh=jm)
    tb = tpipe.make_guidance_builder(
        models["clip"], models["tccfg"], torch.from_numpy(d["targets"]),
        torch.from_numpy(d["weights"]), tpipe.GuidanceSettings(**settings),
        cached_coords=TSpec(*(torch.from_numpy(c) for c in d["coords"])), mesh=tm)

    def jmodel_split(params, x, t, r, y):
        return jmodel(params, jax.lax.with_sharding_constraint(x, jmesh.spatial_sharding(jm)),
                      t, r, y)

    def tmodel_split(x, t, y):
        split = tmesh.split_activation(x, tm)
        return models["unet"](split, t, y).gather()

    meta = jsampler.StepMeta(t=17, guided=True, cutn=CUTN)
    with conv_routing("spmd"):
        jstep = jax.jit(jsampler.make_guided_step(jdiff, jmodel_split, jb(meta), jcfg))
        x_ref, pred_ref, _ = jstep(models["jparams"], jnp.asarray(d["x"]), 17, 20,
                                   jnp.asarray([3]), jax.random.PRNGKey(0),
                                   noise_override=jnp.asarray(d["noise"][0]))
    tstep = tsampler.make_guided_step(tdiff, tmodel_split, tb(tsampler.StepMeta(17, True, CUTN)),
                                      tcfg)
    x_next, pred, _, log = tstep(torch.from_numpy(d["x"]), 17, 20, torch.tensor([3]),
                                 torch.Generator().manual_seed(0),
                                 noise_override=torch.from_numpy(d["noise"][0]))
    assert "Total Loss" in log
    _close(pred, pred_ref, "pred_xstart")
    _close(x_next, x_ref, "x_next")


KW = dict(prompts=["a red cube"], image_size=64, num_cutouts=2, timestep_respacing="ddim5",
          weights_mode="random", device="cpu", compute_dtype="float32", save_frequency=2)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    frames = []
    real = tapi.log_image

    def capture(image, *a, **kw):
        frames.append(np.asarray(image))
        return real(image, *a, **kw)

    monkeypatch.setattr(tapi, "log_image", capture)
    return tmp_path, frames


def test_api_on_a_cpu_mesh_matches_the_single_device_run(tiny, capsys):
    tmp_path, frames = tiny
    single = list(tapi.clip_guided_diffusion(prefix_path=tmp_path / "a", progress=False, **KW))
    n = len(frames)
    split = list(tapi.clip_guided_diffusion(prefix_path=tmp_path / "b", progress=True,
                                            mesh=tmesh.make_mesh([CPU, CPU]), **KW))
    assert [p.split("/")[-1] for _, p in split] == [p.split("/")[-1] for _, p in single]
    assert "Mesh engaged: {'data': 1, 'cut': 2}" in capsys.readouterr().out
    for a, b in zip(frames[n:], frames[:n]):
        np.testing.assert_allclose(a, b, atol=1e-4 * float(np.abs(b).max()))


def test_api_mesh_checks_batch_and_warns_on_uneven_cutouts(tiny, capsys):
    with pytest.raises(ValueError, match="not divisible by the mesh 'data' axis"):
        next(tapi.clip_guided_diffusion(mesh=tmesh.make_mesh([CPU, CPU], data=2),
                                        progress=False, **KW))
    with pytest.raises(ValueError, match="mesh's devices"):
        next(tapi.clip_guided_diffusion(mesh=tmesh.make_mesh([CPU, CPU]),
                                        **{**KW, "device": "cuda"}))
    three = tmesh.make_mesh([CPU] * 3)  # 64px: 64 % 3, the UNet runs whole
    assert next(tapi.clip_guided_diffusion(mesh=three, progress=True, **KW))[0] == 0
    assert "num_cutouts 2 is not divisible by the 3-device mesh" in capsys.readouterr().out


def test_cli_mesh_on_one_device(tiny, capsys):
    tmp_path, _ = tiny
    argv = ["--prompts", "a red cube", "-size", "64", "-cutn", "2", "-respace", "ddim5",
            "--weights-mode", "random", "--device", "cpu", "--compute-dtype", "float32",
            "-freq", "2"]
    tcli.main(argv + ["--mesh", "auto"])
    assert len(sorted((tmp_path / "outputs").rglob("*.png"))) == 3
    assert "--mesh auto: one device visible; running single-chip" in capsys.readouterr().out
    with pytest.raises(ValueError) as err:
        tcli.main(argv + ["--mesh", "cut=2"])
    with pytest.raises(ValueError) as want:
        jmesh.mesh_from_spec("cut=2", jax.devices()[:1])
    assert str(err.value) == str(want.value)
