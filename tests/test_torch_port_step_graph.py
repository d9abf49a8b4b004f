"""What the guided step's CUDA graphs rest on, on the CPU (the capture
itself runs only on a card: tests/test_torch_port_step_graph_cuda.py).

- The capture rule ``sampler._captures``: one CUDA device, no mesh, no
  guidance that reads on the host and a device no other thread uses
  captures; the CPU, a mesh, a loss callback and a shared device stay
  eager. ``sample_loop`` asks it once a key, with the call's mesh and
  ``shared_device`` and the guidance's ``host_reads``, which the pipeline
  sets from its loss callback; the API's rule inputs come from its mesh
  and device lock.
- The step's per-step values as device tensors: the blend's ``fac`` and
  ``1 - fac`` as 0-d float32 tensors give the bits of the float32 scalars
  they replace, and whole loops (DDIM, ancestral, DPM-Solver) through the
  real CLIP guidance are bit-equal to the same loops with the blend as the
  host's floats (the step before the graphs).
- The non-learned-sigma variance is what it was, from a device copy made
  once; LPIPS' shift and scale are made once per device.
- ``kernels.launch_counters`` holds every launch counter of the kernels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch.diffusion import sampler  # noqa: E402
from cgd_tpu_torch.diffusion.gaussian import make_diffusion  # noqa: E402
from cgd_tpu_torch.diffusion.sampler import Blend, GuidanceFns, SamplerConfig  # noqa: E402

torch.set_num_threads(2)

SHAPE = (1, 32, 32, 3)


@pytest.mark.parametrize("device,mesh,host_reads,shared,captures", [
    (torch.device("cuda", 0), None, False, False, True),
    (torch.device("cuda", 1), None, False, False, True),
    (torch.device("cpu"), None, False, False, False),
    (torch.device("cuda", 0), object(), False, False, False),
    (torch.device("cuda", 0), None, True, False, False),
    (torch.device("cuda", 0), None, False, True, False),
], ids=["one-card", "another-card", "cpu", "mesh", "loss-callback", "shared-device"])
def test_the_capture_rule(device, mesh, host_reads, shared, captures):
    assert sampler._captures(device, mesh, host_reads, shared) is captures


def _model_fn(x, t_model, y):
    """A toy eps / variance model: smooth in x, varying with t."""
    s = (t_model.float() / 1000.0).reshape(-1, 1, 1, 1)
    return torch.cat([torch.tanh(x) * (0.5 + s), torch.sin(x) * 0.3 + s - 0.5], dim=-1)


@pytest.fixture(scope="module")
def clip_parts():
    import os

    from cgd_tpu_torch.weights import resolve_clip

    old = os.environ.get("CGD_TPU_DEBUG_TINY")
    os.environ["CGD_TPU_DEBUG_TINY"] = "1"
    try:
        clip, cfg = resolve_clip("ViT-B/32", "random", "cpu")
    finally:
        if old is None:
            del os.environ["CGD_TPU_DEBUG_TINY"]
        else:
            os.environ["CGD_TPU_DEBUG_TINY"] = old
    target = torch.from_numpy(np.random.RandomState(4).randn(1, cfg.embed_dim).astype(np.float32))
    return clip, cfg, target


def _builder(clip_parts, loss_callback=None, host_floats=False):
    """The pipeline's CLIP guidance; ``host_floats`` hands its loss the
    blend as the host's float32 values, the step before the graphs."""
    from cgd_tpu_torch.guidance.pipeline import GuidanceSettings, make_guidance_builder

    clip, cfg, target = clip_parts
    inner = make_guidance_builder(clip, cfg, target, torch.ones(1),
                                  GuidanceSettings(clip_compute_dtype="float32"),
                                  loss_callback=loss_callback)
    if not host_floats:
        return inner

    def build(meta):
        fns = inner(meta)

        def loss_fn(x, out, blend, gen):
            return fns.loss_fn(x, out, blend._replace(fac=float(blend.fac),
                                                      rest=float(blend.rest)), gen)

        return fns._replace(loss_fn=loss_fn)

    return build


def _frames(builder, respacing, **cfg_kw):
    d = make_diffusion(1000, "linear", respacing)
    cfg = SamplerConfig(use_ddim=respacing.startswith("ddim"), **cfg_kw)
    return [(k, p.clone(), x.clone()) for k, p, x in sampler.sample_loop(
        d, _model_fn, builder, SHAPE, torch.Generator().manual_seed(3), cfg, num_cutouts=2,
        save_frequency=1)]


def test_a_zero_d_float32_factor_gives_the_bits_of_the_scalar():
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.randn(4096).astype(np.float32))
    for f in np.concatenate([rs.rand(64), [0.0, 1.0, 1e-30, 0.999999]]).astype(np.float32):
        rest = np.float32(1.0) - f
        want = a * float(f) + a.flip(0) * float(rest)
        got = a * torch.tensor(f) + a.flip(0) * torch.tensor(rest)
        assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("respacing,cfg_kw", [("ddim4", {}), ("4", {}),
                                              ("ddim4", {"dpm_solver": True})],
                         ids=["ddim", "ancestral", "dpm"])
def test_the_blend_as_device_tensors_is_the_host_floats_bit_for_bit(clip_parts, respacing,
                                                                    cfg_kw):
    got = _frames(_builder(clip_parts), respacing, **cfg_kw)
    want = _frames(_builder(clip_parts, host_floats=True), respacing, **cfg_kw)
    assert [k for k, _, _ in got] == [0, 1, 2, 3]
    for (k, p, x), (_, pw, xw) in zip(got, want):
        assert torch.isfinite(x).all() and torch.equal(p, pw) and torch.equal(x, xw), k


def test_the_step_fills_its_own_inputs_in_place():
    d = make_diffusion(1000, "linear", "ddim10")
    step = sampler.make_guided_step(d, _model_fn, None, SamplerConfig(use_ddim=True))
    x = torch.zeros(SHAPE)
    t1, tp1, b1 = step.inputs(x, 7, 8, 6)
    t2, tp2, b2 = step.inputs(x, 3, 2, 4)
    assert t1 is t2 and tp1 is tp2 and b1.fac is b2.fac and b1.rest is b2.rest
    fac = np.float32(d.sqrt_one_minus_alphas_cumprod[2])
    assert t2.tolist() == [3] and tp2.tolist() == [4] and b2.ref_t == 2
    assert b2.fac.dtype == torch.float32 and b2.fac.dim() == 0
    assert b2.fac.item() == fac and b2.rest.item() == np.float32(1.0) - fac


def test_the_loop_asks_the_rule_once_a_key(monkeypatch, clip_parts):
    """The rule sees the loop's device and mesh and the guidance's
    host_reads, at each key's first step."""
    asked = []

    def rule(device, mesh, host_reads, shared):
        asked.append((device.type, mesh, host_reads, shared))
        return False

    monkeypatch.setattr(sampler, "_captures", rule)
    d = make_diffusion(1000, "linear", "ddim5")
    mesh = object()
    list(sampler.sample_loop(d, _model_fn, _builder(clip_parts, loss_callback=lambda log: None),
                             SHAPE, torch.Generator().manual_seed(0),
                             SamplerConfig(use_ddim=True), num_cutouts=2, mesh=mesh,
                             shared_device=True))
    assert asked == [("cpu", mesh, True, True)]
    asked.clear()
    list(sampler.sample_loop(d, _model_fn, _builder(clip_parts), SHAPE,
                             torch.Generator().manual_seed(0), SamplerConfig(use_ddim=True),
                             num_cutouts=2, reduce_clip=True, progressive_cutout=True,
                             skip_timesteps=1))
    assert len(asked) == 3 and all(a == ("cpu", None, False, False) for a in asked)


def test_guidance_reads_on_the_host_only_with_a_callback(clip_parts):
    meta = sampler.StepMeta(t=3, guided=True, cutn=2)
    assert _builder(clip_parts)(meta).host_reads is False
    assert _builder(clip_parts, loss_callback=print)(meta).host_reads is True
    assert GuidanceFns(None, None).host_reads is False


def test_the_fixed_large_variance_is_as_before_from_one_device_copy():
    d = make_diffusion(1000, "linear", "ddim25", learn_sigma=False)
    c = d.coeffs
    t = torch.tensor([0, 1, 13, 24])
    x = torch.randn(4, 8, 8, 3)
    out = d.p_mean_variance(torch.randn(4, 8, 8, 3), x, t)
    before = np.append(c.posterior_variance[1], c.betas[1:]).astype(np.float32)
    want = torch.as_tensor(before)[t].reshape(-1, 1, 1, 1) * torch.ones_like(x)
    assert torch.equal(out.variance, want)
    assert torch.equal(out.log_variance, torch.log(want.clamp_min(1e-20)))
    copies = len(d._device_copies)
    d.p_mean_variance(torch.randn(4, 8, 8, 3), x, t)
    assert len(d._device_copies) == copies
    one = make_diffusion(1, "linear", None, learn_sigma=False)
    assert np.array_equal(one.fixed_large_variance, one.coeffs.posterior_variance)


def test_the_lpips_shift_and_scale_are_made_once_per_device():
    from cgd_tpu_torch.models import vgg_lpips

    a, b = vgg_lpips._shift_scale(torch.device("cpu")), vgg_lpips._shift_scale(torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    assert a[0].tolist() == pytest.approx(vgg_lpips._SHIFT)
    assert a[1].tolist() == pytest.approx(vgg_lpips._SCALE)


def test_the_launch_counters_are_every_kernel_modules():
    from cgd_tpu_torch.kernels import attention, conv3x3, launch_counters, warp

    ids = {id(c) for c in launch_counters()}
    assert {id(conv3x3.LAUNCHES), id(warp.LAUNCHES), id(attention.LAUNCHES)} <= ids
    assert {id(c) for c in attention.LAUNCHES_BY_D.values()} <= ids


def test_a_blend_carries_its_host_index():
    b = Blend(5, torch.tensor(0.5), torch.tensor(0.5))
    assert b.ref_t == 5 and b._replace(fac=0.25).fac == 0.25


@pytest.mark.parametrize("lock", [False, True], ids=["alone", "device-lock"])
def test_the_api_hands_the_loop_its_mesh_and_whether_the_device_is_shared(monkeypatch,
                                                                          tmp_path, lock):
    """A ``device_lock`` (the daemon's, whose other requests prepare on the
    card while one samples) makes the device shared."""
    import threading

    from cgd_tpu_torch import api

    seen = []
    real = api.sample_loop

    def spy(*a, **kw):
        seen.append((kw["mesh"], kw["shared_device"]))
        return real(*a, **kw)

    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(api, "sample_loop", spy)
    list(api.clip_guided_diffusion(
        prompts=["x"], image_size=64, num_cutouts=2, timestep_respacing="ddim2",
        weights_mode="random", device="cpu", compute_dtype="float32", progress=False,
        prefix_path=tmp_path / "out", device_lock=threading.Lock() if lock else None))
    assert seen == [(None, lock)]
