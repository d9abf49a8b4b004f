"""Resume of the port (cgd_tpu_torch/diffusion/sampler.py ``state_sink`` /
``resume``, cgd_tpu_torch/api.py ``checkpoint_path`` / ``resume_from``) on the
CPU, mirroring the JAX package's resume tests (tests/test_sampler.py
TestCheckpointResume, tests/test_api_cli.py TestCheckpointResumeAPI).

The JAX loop derives each segment's key from the seed; the port draws from
one ``torch.Generator``, so its state travels with x, y and x0p. The claim
held here is the JAX package's: a run interrupted after any segment and
resumed gives the uninterrupted run's frames and x BIT FOR BIT (tolerance:
none, ``torch.equal``), for DDIM, ancestral and DPM-Solver++(2M) steps and
with ``reduce_clip`` + ``progressive_cutout``, at save_frequency 1 and 3,
and through the API with ``use_augs`` (the augmentations drawn from the
generator after each step's cutouts, the warp's backward in a fixed order). A
resume from a wrong generator state differs. The guards refuse, each in its
own words: another run configuration, a checkpoint the JAX package wrote,
one drawn on another device type, an unreadable file, a meta that does not
parse, DPM state into a non-DPM run and the reverse; a checkpoint written
after the last segment warns and yields nothing. The port's run meta has
the JAX package's keys (read from cgd_tpu/api.py), ``unet_remat`` included
(tests/test_torch_port_remat.py holds its adoption on resume), plus
``package`` and ``generator``."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch import api  # noqa: E402
from cgd_tpu_torch.diffusion.gaussian import make_diffusion  # noqa: E402
from cgd_tpu_torch.diffusion.sampler import (  # noqa: E402
    GuidanceFns,
    SamplerConfig,
    sample_loop,
)

torch.set_num_threads(2)

SHAPE = (1, 16, 16, 3)
KW = dict(prompts=["resume test"], image_size=64, num_cutouts=2, timestep_respacing="ddim10",
          weights_mode="random", device="cpu", compute_dtype="float32", progress=False,
          seed=11, save_frequency=4)


def _builder(meta):
    """A toy guidance that draws from the generator every guided step, as
    the cutouts do (so the generator's state matters to the result)."""

    def loss_fn(x, out, blend, gen):
        w = torch.rand(x.shape, generator=gen, device=x.device)
        loss = 1e-3 * ((out.pred_xstart * w) ** 2).sum() * meta.cutn
        return loss, {"Total Loss": loss.detach()}

    return GuidanceFns(loss_fn, lambda g: (g, {"Grad": g.mean()}))


def _model_fn(x, t, y):
    return torch.cat([torch.tanh(x), torch.zeros_like(x)], -1)


def _run(cfg, respacing="10", state_sink=None, resume=None, stop_after=None, **loop_kw):
    d = make_diffusion(steps=100, timestep_respacing=respacing)
    gen = torch.Generator().manual_seed(7)
    y0 = torch.zeros((1,), dtype=torch.long) if cfg.randomize_class else None
    out = []
    it = sample_loop(d, _model_fn, _builder, SHAPE, gen, cfg, y_init=y0,
                     state_sink=state_sink, resume=resume, **loop_kw)
    for i, (k, p, x) in enumerate(it):
        out.append((k, p.clone(), x.clone()))
        if stop_after is not None and i + 1 >= stop_after:
            it.close()
            break
    return out


CASES = {
    "ddim": (SamplerConfig(use_ddim=True), {}),
    "ancestral": (SamplerConfig(use_ddim=False, randomize_class=True), {}),
    "dpm": (SamplerConfig(use_ddim=True, dpm_solver=True), {}),
    "reduce_progressive": (SamplerConfig(use_ddim=False),
                           dict(reduce_clip=True, progressive_cutout=True, num_cutouts=8,
                                skip_timesteps=2)),
}


@pytest.mark.parametrize("save_frequency", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_an_interrupted_run_resumed_equals_the_uninterrupted_one(case, save_frequency):
    cfg, extra = CASES[case]
    kw = dict(extra, save_frequency=save_frequency)
    full = _run(cfg, **kw)
    snaps = {}
    for stop in range(1, len(full)):
        part = _run(cfg, state_sink=lambda n, st: snaps.__setitem__(n, st), stop_after=stop, **kw)
        assert len(part) == stop and snaps
        n0 = max(snaps)
        resumed = _run(cfg, resume={"next_seg": n0, **snaps[n0]}, **kw)
        tail = full[len(full) - len(resumed):]
        assert len(resumed) >= 1
        for (k1, p1, x1), (k2, p2, x2) in zip(tail, resumed):
            assert k1 == k2
            assert torch.equal(p1, p2) and torch.equal(x1, x2)
        snaps.clear()


def test_the_state_is_handed_over_before_the_frame_is_yielded():
    """A consumer killed while it saves the frame still resumes from the
    completed segment (state_sink runs before the yield), and
    progress_cb reports each segment's steps after it."""
    events = []
    d = make_diffusion(steps=100, timestep_respacing="10")
    it = sample_loop(d, _model_fn, _builder, SHAPE, torch.Generator().manual_seed(0),
                     SamplerConfig(use_ddim=True), save_frequency=4,
                     state_sink=lambda n, st: events.append(("state", n)),
                     progress_cb=lambda n: events.append(("progress", n)))
    for k, _, _ in it:
        events.append(("yield", k))
    assert events == [("state", 1), ("yield", 0), ("progress", 1),
                      ("state", 2), ("yield", 4), ("progress", 4),
                      ("state", 3), ("yield", 8), ("progress", 4),
                      ("state", 4), ("yield", 9), ("progress", 1)]


def test_a_wrong_generator_state_gives_another_run():
    cfg = SamplerConfig(use_ddim=False)
    full = _run(cfg, save_frequency=3)
    snaps = {}
    _run(cfg, state_sink=lambda n, st: snaps.__setitem__(n, st), stop_after=2, save_frequency=3)
    wrong = dict(snaps[2], generator=torch.Generator().manual_seed(7).get_state().numpy())
    resumed = _run(cfg, resume={"next_seg": 2, **wrong}, save_frequency=3)
    assert not torch.equal(resumed[-1][2], full[-1][2])


def test_loss_and_image_sinks_get_every_guided_step():
    """The losses reach the host inside the guidance, as the API's loss
    callback does (a step that reads them is never replayed from a graph);
    the image sink gets every guided step's x_t and prediction after each
    segment."""
    logs, taps = [], []

    def builder(meta):
        inner = _builder(meta)

        def loss_fn(x, out, blend, gen):
            loss, log = inner.loss_fn(x, out, blend, gen)
            logs.append({k: float(v) for k, v in log.items()})
            return loss, log

        return GuidanceFns(loss_fn, inner.grad_transform, host_reads=True)

    d = make_diffusion(steps=100, timestep_respacing="10")
    outs = list(sample_loop(d, _model_fn, builder, SHAPE, torch.Generator().manual_seed(0),
                            SamplerConfig(use_ddim=True), save_frequency=4,
                            image_sink=lambda ks, n, p: taps.append((ks, n.shape, p.shape))))
    assert [o[0] for o in outs] == [0, 4, 8, 9]
    assert len(logs) == 10 and set(logs[0]) == {"Total Loss"}
    assert [ks for ks, _, _ in taps] == [[0], [1, 2, 3, 4], [5, 6, 7, 8], [9]]
    assert taps[1][1] == taps[1][2] == (4, *SHAPE)


def test_resume_guards_in_the_loop():
    x = np.zeros(SHAPE, np.float32)
    gstate = torch.Generator().get_state().numpy()
    with pytest.raises(ValueError, match="outside this plan"):
        _run(SamplerConfig(use_ddim=True), save_frequency=3,
             resume={"next_seg": 99, "x": x, "y": None, "generator": gstate})
    with pytest.raises(ValueError, match="dpm_solver is False"):
        _run(SamplerConfig(use_ddim=True), save_frequency=3,
             resume={"next_seg": 1, "x": x, "y": None, "x0p": x, "generator": gstate})
    with pytest.raises(ValueError, match="lacks the dpm_solver"):
        _run(SamplerConfig(use_ddim=True, dpm_solver=True), save_frequency=3,
             resume={"next_seg": 1, "x": x, "y": None, "generator": gstate})
    with pytest.warns(UserWarning, match="marks the run complete"):
        assert _run(SamplerConfig(use_ddim=True), save_frequency=3,
                    resume={"next_seg": 4, "x": x, "y": None, "generator": gstate}) == []


# ---- through the API ----------------------------------------------------

@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _frames(paths):
    return [open(p, "rb").read() for _, p in paths]


@pytest.mark.parametrize("dpm,augs", [(False, False), (True, False), (False, True)],
                         ids=["ddim", "dpm", "augs"])
def test_checkpoint_and_resume_through_the_api_equal_the_uninterrupted_run(tiny, dpm, augs):
    kw = dict(KW, dpm_solver=dpm, use_augs=augs)
    full = _frames(api.clip_guided_diffusion(prefix_path=tiny / "full", **kw))
    ck = str(tiny / "state.npz")
    gen = api.clip_guided_diffusion(prefix_path=tiny / "part", checkpoint_path=ck, **kw)
    next(gen)
    gen.close()  # interrupted run
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")
    rec = np.load(ck)
    assert set(rec.files) == {"next_seg", "x", "y", "generator", "meta"} | (
        {"x0p"} if dpm else set())
    assert int(rec["next_seg"]) == 1 and rec["generator"].dtype == np.uint8
    resumed = _frames(api.clip_guided_diffusion(prefix_path=tiny / "res", resume_from=ck, **kw))
    assert len(resumed) == len(full) - 1 and resumed == full[1:]
    # DPM state into a DDIM run and the reverse: the run meta refuses both
    with pytest.raises(ValueError, match="different run configuration"):
        next(api.clip_guided_diffusion(prefix_path=tiny / "x", resume_from=ck,
                                       **dict(kw, dpm_solver=not dpm)))


def _jax_run_meta_keys():
    """The keys of cgd_tpu.api's run meta, read from its source."""
    import cgd_tpu.api as japi

    tree = ast.parse(Path(japi.__file__).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "run_meta"
                and isinstance(node.value, ast.Call)):
            return {k.value for k in node.value.args[0].keys}
    raise AssertionError("no run_meta in cgd_tpu/api.py")


def _checkpoint(tiny, **over):
    ck = tiny / "ck.npz"
    gen = api.clip_guided_diffusion(prefix_path=tiny / "w", checkpoint_path=str(ck), **KW)
    next(gen)
    gen.close()
    rec = dict(np.load(ck))
    rec.update(over)
    np.savez(ck, **{k: v for k, v in rec.items() if v is not None})
    return str(ck)


def test_the_run_meta_is_jax_less_remat_plus_package_and_generator(tiny):
    meta = json.loads(str(np.load(_checkpoint(tiny))["meta"]))
    jax_keys = _jax_run_meta_keys()
    assert "unet_remat" in jax_keys
    assert set(meta) == jax_keys | {"package", "generator"}
    assert meta["package"] == "cgd_tpu_torch" and meta["generator"] == "cpu"
    assert meta["unet_remat"] is False  # 64px: the gate says no


def _guarded(tiny, ck, match):
    with pytest.raises(ValueError, match=match):
        next(api.clip_guided_diffusion(prefix_path=tiny / "r", resume_from=ck, **KW))


def test_a_different_configuration_is_refused(tiny):
    ck = _checkpoint(tiny)
    with pytest.raises(ValueError, match="different run configuration"):
        next(api.clip_guided_diffusion(prefix_path=tiny / "r", resume_from=ck,
                                       **dict(KW, seed=12)))


def test_a_jax_checkpoint_is_refused_by_name(tiny):
    """The JAX package's keys and meta (its remat decision, no package, no
    generator state)."""
    meta = {k: None for k in _jax_run_meta_keys()}
    meta.update(json.loads(str(np.load(_checkpoint(tiny))["meta"])))
    for k in ("package", "generator"):
        meta.pop(k)
    meta["unet_remat"] = False
    ck = tiny / "jax.npz"
    np.savez(ck, next_seg=1, x=np.zeros((1, 64, 64, 3), np.float32),
             y=np.zeros((1,), np.int32), meta=json.dumps(meta, sort_keys=True))
    _guarded(tiny, str(ck), "JAX package cgd_tpu.*no torch.Generator state")


def test_another_device_type_is_refused(tiny):
    rec = np.load(_checkpoint(tiny))
    meta = dict(json.loads(str(rec["meta"])), generator="cuda")
    _guarded(tiny, _checkpoint(tiny, meta=json.dumps(meta, sort_keys=True)),
             "written on device type 'cuda'")


def test_corrupt_meta_and_unreadable_files_have_their_own_messages(tiny):
    _guarded(tiny, _checkpoint(tiny, meta="{not json"), "does not parse.*corrupt")
    (tiny / "junk.npz").write_bytes(b"not an npz")
    _guarded(tiny, str(tiny / "junk.npz"), "not a readable checkpoint")
    _guarded(tiny, str(tiny / "missing.npz"), "not a readable checkpoint")


def test_a_checkpoint_of_a_finished_run_warns_and_yields_nothing(tiny):
    ck = tiny / "done.npz"
    list(api.clip_guided_diffusion(prefix_path=tiny / "w", checkpoint_path=str(ck), **KW))
    assert int(np.load(ck)["next_seg"]) == 4
    with pytest.warns(UserWarning, match="marks the run complete"):
        assert list(api.clip_guided_diffusion(prefix_path=tiny / "r", resume_from=str(ck),
                                              **KW)) == []
