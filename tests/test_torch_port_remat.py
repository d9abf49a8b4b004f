"""The port's UNet rematerialization and its memory policy on the CPU.

``UNet.forward(remat_min_dim=N)`` and ``models.unet.rematerialized`` run
layers under non-reentrant ``torch.utils.checkpoint``: the recompute runs
the same ops on the same values, so the output and the input gradient are
equal to the no-remat ones bit for bit (``torch.equal``), on whole and on
height-split (``Split``) activations. Against the JAX package's
``apply_unet(..., remat_min_dim=...)`` on the same weights (carried across
by ``convert/from_jax.py``) they agree within atol = rtol = 1e-3 (the bound
of tests/test_torch_port_unet.py).

``api._resolve_remat`` keeps the JAX signature and the ``CGD_TPU_REMAT=0/1``
override, with the H100's thresholds (pinned below, as
tests/test_api_cli.py pins the JAX gate). The decision is ``unet_remat`` in
the run meta; a resume adopts the checkpoint's recorded decision whatever
the environment says, and a checkpoint written before the key existed
resumes as False.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cgd_tpu.models import unet as junet  # noqa: E402
from cgd_tpu_torch import api  # noqa: E402
from cgd_tpu_torch.convert.from_jax import load_from_jax  # noqa: E402
from cgd_tpu_torch.models import unet as tunet  # noqa: E402
from cgd_tpu_torch.parallel.mesh import make_mesh, split_activation  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-3, rtol=1e-3)
KW = dict(prompts=["remat adopt"], image_size=64, num_cutouts=2, timestep_respacing="ddim6",
          weights_mode="random", device="cpu", compute_dtype="float32", progress=False,
          seed=9, save_frequency=3)


@pytest.fixture(scope="module")
def toy():
    kw = dict(image_size=32, model_channels=32, num_res_blocks=1, attention_ds=(2,),
              channel_mult=(1, 2), num_head_channels=16, num_classes=7)
    jcfg, tcfg = junet.UNetConfig(**kw), tunet.UNetConfig(**kw)
    params = junet.init_unet(jax.random.PRNGKey(3), jcfg)
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(3)
    params = jax.tree.unflatten(treedef, [
        jnp.asarray(np.asarray(l) + 0.05 * rs.randn(*l.shape).astype(np.float32))
        for l in leaves])
    rs = np.random.RandomState(4)
    return dict(
        jcfg=jcfg, params=params, model=load_from_jax(tunet.UNet(tcfg), params),
        x=rs.randn(2, 32, 32, 3).astype(np.float32), t=np.array([10.0, 700.0], np.float32),
        y=np.array([1, 5]), probe=rs.randn(2, 32, 32, 6).astype(np.float32))


def _torch_run(toy, fn):
    """(output, input gradient of sum(sin(out) * probe)) of ``fn(x, t, y)``."""
    x = torch.from_numpy(toy["x"]).requires_grad_(True)
    out = fn(x, torch.from_numpy(toy["t"]), torch.from_numpy(toy["y"]))
    (g,) = torch.autograd.grad((torch.sin(out) * torch.from_numpy(toy["probe"])).sum(), x)
    return out.detach(), g


POLICIES = {
    "none": lambda m: m,
    "hires32": lambda m: lambda *a: m(*a, remat_min_dim=32),
    "hires16": lambda m: lambda *a: m(*a, remat_min_dim=16),
    "whole": lambda m: tunet.rematerialized(m),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_remat_gives_the_no_remat_output_and_gradient_exactly(toy, policy):
    want = _torch_run(toy, toy["model"])
    got = _torch_run(toy, POLICIES[policy](toy["model"]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_remat_recomputes_the_layers_at_or_above_the_height(toy, monkeypatch):
    """hires32 checkpoints the 32-row level's layers only, hires16 every
    layer (the toy's levels are 32 and 16 rows high); each checkpointed
    layer runs its forward twice under a gradient."""
    calls = []
    real = tunet.checkpoint

    def spy(fn, *a, **kw):
        calls.append(a[0].shape[1])
        assert kw == {"use_reentrant": False, "preserve_rng_state": False}
        return real(fn, *a, **kw)

    monkeypatch.setattr(tunet, "checkpoint", spy)
    _torch_run(toy, POLICIES["hires32"](toy["model"]))
    assert calls and set(calls) == {32}
    calls.clear()
    _torch_run(toy, POLICIES["hires16"](toy["model"]))
    assert set(calls) == {32, 16}


@pytest.mark.parametrize("remat_min_dim", [None, 32, 16])
def test_remat_matches_jax_apply_unet_with_remat(toy, remat_min_dim):
    jcfg, params = toy["jcfg"], toy["params"]

    def jloss(x_):
        out = junet.apply_unet(params, jcfg, x_, jnp.asarray(toy["t"]), jnp.asarray(toy["y"]),
                               remat_min_dim=remat_min_dim)
        return jnp.sum(jnp.sin(out) * toy["probe"]), out

    (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(toy["x"]))
    out, g = _torch_run(toy, lambda *a: toy["model"](*a, remat_min_dim=remat_min_dim))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), **TOL)


@pytest.mark.parametrize("policy", ["hires16", "whole"])
def test_a_split_activation_passes_through_the_checkpoint(toy, policy):
    """The height-split UNet (make_mesh([cpu, cpu]): cut=2) under remat
    equals the split UNet without it; the height checked is the whole
    activation's (32 and 16 rows here, 16 and 8 a shard)."""
    mesh = make_mesh(["cpu", "cpu"])
    model = toy["model"]

    def split(fn):
        return lambda x, t, y: fn(split_activation(x, mesh), t, y).gather()

    want = _torch_run(toy, split(model))
    if policy == "whole":
        got = _torch_run(toy, tunet.rematerialized(split(model)))
    else:
        got = _torch_run(toy, split(lambda *a: model(*a, remat_min_dim=16)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_remat_under_no_grad_runs_the_plain_forward(toy):
    x, t, y = (torch.from_numpy(toy[k]) for k in ("x", "t", "y"))
    with torch.no_grad():
        want = toy["model"](x, t, y)
        assert torch.equal(tunet.rematerialized(toy["model"])(x, t, y), want)
        assert torch.equal(toy["model"](x, t, y, remat_min_dim=16), want)


# ---- the gate -------------------------------------------------------------

def test_the_h100_gate(monkeypatch):
    """The fit of the 512px RN50x16 grid (chip_smoke.py phase 14c, NVIDIA
    H100 80GB HBM3): no remat wherever the no-remat step's peak stays under
    90% of the card's 79.2 GiB; smaller images never remat."""
    monkeypatch.delenv("CGD_TPU_REMAT", raising=False)
    gate = api._resolve_remat
    for size, b, cutn in ((64, 64, 64), (128, 32, 32), (256, 16, 64)):
        assert not gate(size, b, cutn)
    assert not gate(512, 1, 16)   # measured: 7.63 GiB
    assert not gate(512, 8, 16)   # measured: 44.66 GiB
    assert not gate(512, 8, 32)   # measured: 68.75 GiB, under 71.3
    assert not gate(512, 13, 16)  # reckoned: 71.1 GiB
    assert gate(512, 14, 16)      # reckoned: 76.4 GiB
    assert gate(512, 9, 32)       # reckoned: 76.6 GiB
    assert gate(512, 5, 64) and not gate(512, 4, 64)
    for cutn, first in ((16, 14), (32, 9), (64, 5)):
        assert all(gate(512, b, cutn) for b in range(first, first + 16))  # monotone in b


def test_the_env_override_is_read_on_every_call(monkeypatch):
    monkeypatch.setenv("CGD_TPU_REMAT", "1")
    assert api._resolve_remat(64, 1, 2)
    monkeypatch.setenv("CGD_TPU_REMAT", "0")
    assert not api._resolve_remat(512, 64, 64)
    assert not api._resolve_remat(64, 1, 2)
    monkeypatch.setenv("CGD_TPU_REMAT", "1")
    assert api._resolve_remat(64, 1, 2)
    monkeypatch.setenv("CGD_TPU_REMAT", "yes")  # neither 0 nor 1: the gate decides
    assert not api._resolve_remat(64, 1, 2)


# ---- run meta and resume ------------------------------------------------------

@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.delenv("CGD_TPU_REMAT", raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def remat_calls(monkeypatch):
    """How many times the API wrapped its model function in the checkpoint."""
    calls = []
    real = api.rematerialized

    def spy(fn):
        calls.append(fn)
        return real(fn)

    monkeypatch.setattr(api, "rematerialized", spy)
    return calls


def _meta(path):
    return json.loads(str(np.load(path)["meta"]))


def _x(path):
    return np.load(path)["x"]


def test_unet_remat_is_in_the_run_meta(tiny, monkeypatch, remat_calls):
    for env, want in ((None, False), ("1", True), ("0", False)):
        if env is None:
            monkeypatch.delenv("CGD_TPU_REMAT", raising=False)
        else:
            monkeypatch.setenv("CGD_TPU_REMAT", env)
        ck = tiny / f"{env}.npz"
        remat_calls.clear()
        list(api.clip_guided_diffusion(prefix_path=tiny / str(env), checkpoint_path=str(ck),
                                       **KW))
        assert _meta(ck)["unet_remat"] is want
        assert len(remat_calls) == int(want)


def test_a_resume_adopts_the_recorded_decision_under_another_env(tiny, monkeypatch,
                                                                  remat_calls):
    """As tests/test_api_cli.py's TestResumeAdoptsRecordedRemat: written under
    CGD_TPU_REMAT=1, resumed with it unset (and with it 0) — the gate says
    no at 64px — the resume replays the recorded remat and continues
    bit-equal to the uninterrupted remat run."""
    monkeypatch.setenv("CGD_TPU_REMAT", "1")
    list(api.clip_guided_diffusion(prefix_path=tiny / "full", checkpoint_path=str(tiny / "A.npz"),
                                   **KW))
    gen = api.clip_guided_diffusion(prefix_path=tiny / "part",
                                    checkpoint_path=str(tiny / "part.npz"), **KW)
    next(gen)
    gen.close()
    assert _meta(tiny / "part.npz")["unet_remat"] is True
    for env in (None, "0"):
        if env is None:
            monkeypatch.delenv("CGD_TPU_REMAT", raising=False)
        else:
            monkeypatch.setenv("CGD_TPU_REMAT", env)
        remat_calls.clear()
        out = tiny / f"resumed_{env}.npz"
        resumed = list(api.clip_guided_diffusion(prefix_path=tiny / f"r{env}",
                                                 resume_from=str(tiny / "part.npz"),
                                                 checkpoint_path=str(out), **KW))
        assert resumed and len(remat_calls) == 1
        assert _meta(out)["unet_remat"] is True
        np.testing.assert_array_equal(_x(out), _x(tiny / "A.npz"))


def test_a_checkpoint_without_the_key_resumes_as_false(tiny, monkeypatch, remat_calls):
    """A checkpoint written before ``unet_remat`` joined the meta (no port
    run rematerialized then): it resumes under CGD_TPU_REMAT=1 as well,
    without remat, to the uninterrupted run's x."""
    list(api.clip_guided_diffusion(prefix_path=tiny / "full", checkpoint_path=str(tiny / "A.npz"),
                                   **KW))
    gen = api.clip_guided_diffusion(prefix_path=tiny / "part",
                                    checkpoint_path=str(tiny / "part.npz"), **KW)
    next(gen)
    gen.close()
    rec = dict(np.load(tiny / "part.npz"))
    meta = json.loads(str(rec["meta"]))
    assert meta.pop("unet_remat") is False
    rec["meta"] = json.dumps(meta, sort_keys=True)
    np.savez(tiny / "legacy.npz", **rec)
    monkeypatch.setenv("CGD_TPU_REMAT", "1")
    remat_calls.clear()
    resumed = list(api.clip_guided_diffusion(prefix_path=tiny / "r",
                                             resume_from=str(tiny / "legacy.npz"),
                                             checkpoint_path=str(tiny / "B.npz"), **KW))
    assert resumed and remat_calls == []
    assert _meta(tiny / "B.npz")["unet_remat"] is False
    np.testing.assert_array_equal(_x(tiny / "B.npz"), _x(tiny / "A.npz"))


def test_a_recorded_decision_does_not_hide_another_configuration(tiny, monkeypatch):
    """The meta is compared with the recorded decision in: another seed is
    still refused by the configuration check."""
    monkeypatch.setenv("CGD_TPU_REMAT", "1")
    gen = api.clip_guided_diffusion(prefix_path=tiny / "part",
                                    checkpoint_path=str(tiny / "part.npz"), **KW)
    next(gen)
    gen.close()
    monkeypatch.delenv("CGD_TPU_REMAT")
    with pytest.raises(ValueError, match="different run configuration"):
        next(api.clip_guided_diffusion(prefix_path=tiny / "r", resume_from=str(tiny / "part.npz"),
                                       **dict(KW, seed=10)))
