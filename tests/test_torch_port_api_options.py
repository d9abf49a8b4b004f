"""The sampler's options through cgd_tpu_torch.api.clip_guided_diffusion on
the CPU at toy size (CGD_TPU_DEBUG_TINY=1, random weights, 64px): each
option the API once refused reaching the sampler, the augmentations,
reduce_clip's skip and gating, the cutout cache under progressive_cutout,
the height / width offsets (with an init image under both parity modes,
and on a mesh), recorded noise replayed through noise_file, and the 64px
model's magnitude clamp, each with cgd_tpu's messages and errors where it
has them. (DPM-Solver++(2M) and fast guidance are held to cgd_tpu in
tests/test_torch_port_sampler_options.py.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgd_tpu import api as japi  # noqa: E402
from cgd_tpu_torch import api  # noqa: E402
from tests.test_torch_port_api import KW, _png_file, _read_png, tiny  # noqa: E402,F401

torch.set_num_threads(2)
# ---------------------------------------------------------------------------
# the sampler's options through the API (augs, DPM-Solver++(2M), fast
# guidance, reduce_clip, progressive cutouts, offsets, recorded noise)
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _jax_messages(capsys, monkeypatch, **kw):
    """What cgd_tpu's API prints for a toy run of ``kw`` up to its sampling
    loop (stopped there: no segment is compiled)."""
    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(japi, "sample_loop", stop)
    kw = dict(dict(prompts=KW["prompts"], num_cutouts=2, timestep_respacing="ddim5",
                   weights_mode="random", progress=True), **kw)
    with pytest.raises(_Stop):
        next(japi.clip_guided_diffusion(**kw))
    return capsys.readouterr().out


@pytest.mark.parametrize("option", [
    {"reduce_clip": True}, {"progressive_cutout": True}, {"use_augs": True},
    {"dpm_solver": True}, {"fast_guidance": True}, {"height_offset": 8},
    {"width_offset": 8}, {"noise_file": "noise.npz"},
], ids=lambda o: next(iter(o)))
def test_the_options_once_refused_reach_the_sampler(tiny, option, monkeypatch):
    """Each sampler option the API once refused runs: it reaches the
    sampler, and the run writes its frames, at the offset sides where one
    is given (noise_file: a recorded file of the JAX package's layout)."""
    (name,) = option
    if name == "noise_file":
        rs = np.random.RandomState(0)
        np.savez(tiny / "noise.npz", init=rs.randn(1, 64, 64, 3).astype(np.float32),
                 steps=rs.randn(5, 1, 64, 64, 3).astype(np.float32))
    seen = []
    real = api.sample_loop

    def spy(diffusion, model_fn, builder, shape, gen, cfg, **kw):
        seen.append((shape, cfg, kw))
        return real(diffusion, model_fn, builder, shape, gen, cfg, **kw)

    monkeypatch.setattr(api, "sample_loop", spy)
    gen = api.clip_guided_diffusion(**{**KW, **option})
    _, path = next(gen)
    gen.close()
    ((shape, cfg, kw),) = seen
    if name in ("dpm_solver", "fast_guidance"):
        assert getattr(cfg, name)
    elif name in ("reduce_clip", "progressive_cutout"):
        assert kw[name]
    elif name == "noise_file":
        assert kw["init_noise"].shape == (1, 64, 64, 3)
        assert kw["noise_override"].shape == (5, 1, 64, 64, 3)
    assert shape == (1, 64 + option.get("height_offset", 0), 64 + option.get("width_offset", 0), 3)
    assert _read_png(path).shape == shape[1:]


@pytest.mark.parametrize("strict_parity", [True, False])
def test_offsets_with_an_init_image_follow_strict_parity(tiny, monkeypatch, capsys,
                                                         strict_parity):
    """An init image with offsets raises cgd_tpu's ValueError under
    strict_parity (the reference resizes the init square while the sample
    carries the offsets); otherwise the init is resized to the offset shape
    (w, h) and the frames have it."""
    init = _png_file(tiny / "init.png", 50, 70, 7)
    kw = dict(init_image=init, skip_timesteps=2, height_offset=8, width_offset=16,
              strict_parity=strict_parity)
    if strict_parity:
        with pytest.raises(ValueError) as ours:
            next(api.clip_guided_diffusion(**{**KW, **kw}))
        with pytest.raises(ValueError) as theirs:
            _jax_messages(capsys, monkeypatch, image_size=64, **kw)
        assert str(ours.value) == str(theirs.value)
        return
    sizes = []
    real = api.load_image_rgb
    monkeypatch.setattr(api, "load_image_rgb", lambda p, size: sizes.append(size) or real(p, size))
    frames = list(api.clip_guided_diffusion(**{**KW, **kw}, save_frequency=1))
    assert sizes == [(80, 72)] and len(frames) == 3
    assert _read_png(frames[-1][1]).shape == (72, 80, 3)


def test_noise_file_replays_a_recorded_run(tiny, monkeypatch):
    """A run's own noise (the starting noise and each step's), recorded to
    the JAX package's npz layout {"init", "steps"} and replayed through
    noise_file, gives the same frames: the replay draws every other random
    number (class labels, cutouts, augmentations) as the recorded run did.
    Ancestral sampling, so that the step noise reaches the frames; replays
    with the steps reversed and with the starting noise halved differ (the
    replay's generator draws the recorded noise anyway)."""
    kw = dict(KW, use_augs=True, save_frequency=1, timestep_respacing="5")
    drawn = []
    real_randn = torch.randn

    def recording(*a, **k):
        out = real_randn(*a, **k)
        if tuple(out.shape) == (1, 64, 64, 3) and k.get("generator") is not None:
            drawn.append(out.clone().numpy())
        return out

    monkeypatch.setattr(torch, "randn", recording)
    first = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "a", **kw)]
    monkeypatch.setattr(torch, "randn", real_randn)
    assert len(drawn) == 6  # the start and five steps
    np.savez(tiny / "noise.npz", init=drawn[0], steps=np.stack(drawn[1:]))
    again = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "b", noise_file=str(tiny / "noise.npz"), **kw)]
    np.savez(tiny / "other.npz", init=drawn[0], steps=np.stack(drawn[1:])[::-1])
    other = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "c", noise_file=str(tiny / "other.npz"), **kw)]
    np.savez(tiny / "halved.npz", init=0.5 * drawn[0], steps=np.stack(drawn[1:]))
    halved = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "d", noise_file=str(tiny / "halved.npz"), **kw)]
    assert len(first) == 5 and first == again
    assert other[0] == first[0] and other[1:] != first[1:]
    assert halved[0] != first[0]


def test_64px_turns_on_magnitude_and_says_so_as_cgd_tpu(tiny, monkeypatch, capsys):
    """At 64px the API enables the magnitude clamp and prints cgd_tpu's
    line; other sizes leave it as given."""
    settings = []
    real = api.GuidanceSettings
    monkeypatch.setattr(api, "GuidanceSettings", lambda **k: settings.append(k) or real(**k))
    gen = api.clip_guided_diffusion(**{**KW, "progress": True})
    next(gen)
    gen.close()
    said = capsys.readouterr().out
    assert "Enabling magnitude for 64x64 checkpoints." in said
    jsaid = _jax_messages(capsys, monkeypatch, image_size=64)
    assert "Enabling magnitude for 64x64 checkpoints." in jsaid
    gen = api.clip_guided_diffusion(**{**KW, "image_size": 128})
    next(gen)
    gen.close()
    assert [s["use_magnitude"] for s in settings] == [True, False]


def test_reduce_clip_skips_a_fifth_and_gates_the_guidance(tiny, monkeypatch, capsys):
    """reduce_clip with no skip skips int(0.2 T) steps with cgd_tpu's message
    (ddim10: 2), and the loop gets the gating; with a skip given, none is
    added."""
    seen = []
    real = api.sample_loop

    def spy(*a, **kw):
        seen.append((kw["skip_timesteps"], kw["reduce_clip"]))
        return real(*a, **kw)

    monkeypatch.setattr(api, "sample_loop", spy)
    kw = {**KW, "timestep_respacing": "ddim10", "progress": True, "reduce_clip": True}
    frames = list(api.clip_guided_diffusion(**kw, save_frequency=1))
    said = capsys.readouterr().out
    list(api.clip_guided_diffusion(**kw, skip_timesteps=3))
    assert seen == [(2, True), (3, True)] and len(frames) == 8
    msg = "Skipping first 2 timesteps (--reduce-clip optimization)"
    assert msg in said
    assert msg in _jax_messages(capsys, monkeypatch, image_size=64,
                                timestep_respacing="ddim10", reduce_clip=True)


@pytest.mark.parametrize("progressive", [False, True])
def test_the_cutout_cache_holds_the_largest_step_at_the_offset_sides(tiny, monkeypatch,
                                                                   progressive):
    """cached_cutouts draws the cache once at the sample's offset sides
    (side_x = 64 + 16, side_y = 64 + 8), sized max(num_cutouts, 8) under
    progressive_cutout (which asks for 8 cutouts in its middle phase)."""
    calls = []
    real = api.sample_cutout_coords

    def spy(gen, n, side_x, side_y, *a, **k):
        calls.append((n, side_x, side_y))
        return real(gen, n, side_x, side_y, *a, **k)

    monkeypatch.setattr(api, "sample_cutout_coords", spy)
    frames = list(api.clip_guided_diffusion(
        **KW, cached_cutouts=True, progressive_cutout=progressive, height_offset=8,
        width_offset=16))
    assert calls == [(8 if progressive else 2, 80, 72)]
    assert _read_png(frames[-1][1]).shape == (72, 80, 3)


def test_use_augs_says_so_and_changes_the_frames(tiny, capsys):
    """use_augs prints cgd_tpu's line; the first frame (the UNet's own
    prediction) is the plain run's, the guided ones differ."""
    plain = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "a", **KW)]
    augs = [open(p, "rb").read() for _, p in api.clip_guided_diffusion(
        prefix_path=tiny / "b", **{**KW, "progress": True}, use_augs=True)]
    assert "Augmentations enabled." in capsys.readouterr().out
    assert len(augs) == len(plain) == 2
    assert augs[0] == plain[0] and augs[-1] != plain[-1]


@pytest.mark.parametrize("height_offset", [8, 2])
def test_offsets_on_a_mesh_run_as_in_cgd_tpu(tiny, height_offset):
    """mesh= with an offset height: cgd_tpu raises for none of these (its
    partitioner pads a height the 'cut' axis does not divide); the port
    splits a height cut divides and runs a level it does not divide whole
    (66 rows: 33 a shard, then 33 rows whole)."""
    from cgd_tpu_torch.parallel.mesh import make_mesh

    frames = list(api.clip_guided_diffusion(
        **KW, mesh=make_mesh([torch.device("cpu")] * 2), height_offset=height_offset))
    assert _read_png(frames[-1][1]).shape == (64 + height_offset, 64, 3)
