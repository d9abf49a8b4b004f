"""The guided step replayed as a CUDA graph (``diffusion/sampler.py``:
``_StepGraph``) on a card, held to the same API call run eagerly (the
sampler's capture rule ``_captures`` patched to refuse), from one seed and
the same random weights (the UNet's zero-init layers drawn, so that its
output and gradient are not 0): every yielded frame and x, x and the
generator's state at every segment end and the generator's state after the
run are bit-equal, and so are the kernels' launch counts. Under tracing
every step after its key's first reads ``graph`` = 1, one ``step.capture``
a key. Three calls back to back leave the card's allocated memory where one
call leaves it: no graph and no pool outlives its call. A call given a
``device_lock`` (the serving daemon's) stays eager while another thread
works on the card, and both finish.

The cases: both benchmark configurations at their cells' settings (256px
ViT-B/32 DDIM at b = 1 and b = 4; 512px class-conditional RN50x16, 1000
ancestral steps with a random class each step, 21 of them run), the
progressive cutouts with the CLIP reduction (keys of 4, 8 and 16 cutouts
and unguided ones), DPM-Solver++(2M), recorded noise, a resume from a
mid-run checkpoint, and the other paths of the step: the init image with
the LPIPS loss and the augmentations, float32, the rematerialized UNet and
fast guidance.

Marked ``cuda``; imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_step_graph_cuda.py
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

CELL256 = dict(image_size=256, class_cond=False, randomize_class=False, num_cutouts=16,
               clip_model_name="ViT-B/32", clip_guidance_scale=1000, tv_scale=150,
               range_scale=50, timestep_respacing="ddim20", save_frequency=5, batch_size=1)
CELL512 = dict(image_size=512, class_cond=True, randomize_class=True, num_cutouts=16,
               clip_model_name="RN50x16", clip_guidance_scale=1500, tv_scale=150,
               range_scale=50, timestep_respacing="1000", save_frequency=5, batch_size=1)
SHORT = dict(CELL256, timestep_respacing="ddim10", save_frequency=3)

CASES = {
    "cog256": (CELL256, None),
    "batch256": (dict(CELL256, batch_size=4), None),
    "acc512-randomize-class": (CELL512, 5),  # stopped after its frame at step 20
    "progressive-reduce": (dict(CELL256, timestep_respacing="ddim25", save_frequency=3,
                                reduce_clip=True, progressive_cutout=True), None),
    "dpm-solver": (dict(CELL256, dpm_solver=True), None),
    "init-lpips-augs": (dict(SHORT, skip_timesteps=4, init_scale=1000, use_augs=True), None),
    "float32": (dict(SHORT, compute_dtype="float32"), None),
    "remat": (SHORT, None),
    "fast-guidance": (dict(SHORT, fast_guidance=True), None),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


class Record:
    """What one call gave: the yielded (k, pred_x0, x), each segment end's
    (next_seg, x, generator state), the generator's state at the end, the
    step spans and the launch counts."""

    def __init__(self):
        self.frames, self.segments, self.state, self.spans, self.launches = [], [], None, [], {}


@pytest.fixture
def run(dev, tmp_path, monkeypatch):
    """run(name, graphs, stop=None, **kw) -> Record: one API call on the
    card with random weights; ``graphs`` False patches the capture rule to
    refuse; ``stop``: interrupt the call after that many frames."""
    from cgd_tpu_torch import api
    from cgd_tpu_torch.diffusion import sampler
    from cgd_tpu_torch.kernels import launch_counters
    from cgd_tpu_torch.models.unet import Conv, Dense
    from cgd_tpu_torch.utils import tracing

    monkeypatch.chdir(tmp_path)  # the API writes current.png beside its frames
    real_resolve, real_loop, real_rule = api.resolve_unet, api.sample_loop, sampler._captures

    def resolve_drawn(*a, **kw):
        unet, *rest = real_resolve(*a, **kw)
        gen = torch.Generator(dev).manual_seed(9)
        with torch.no_grad():
            for m in unet.modules():
                if isinstance(m, (Conv, Dense)) and m.zero:
                    bound = 1.0 / float(np.prod(m.kernel.shape[:-1])) ** 0.5
                    m.kernel.uniform_(-bound, bound, generator=gen)
        return (unet, *rest)

    now = {}  # the call in progress: its Record and whether graphs are allowed

    def spy(*a, **skw):
        rec, gen, sink = now["rec"], a[4], skw.get("state_sink")

        def record(next_seg, st):
            rec.segments.append((next_seg, st["x"].copy(), st["generator"].copy()))
            if sink is not None:
                sink(next_seg, st)

        skw["state_sink"] = record
        try:
            for k, pred, x in real_loop(*a, **skw):
                rec.frames.append((k, pred.clone(), x.clone()))
                yield k, pred, x
        finally:
            rec.state = gen.get_state().clone()

    monkeypatch.setattr(api, "resolve_unet", resolve_drawn)
    monkeypatch.setattr(api, "sample_loop", spy)
    monkeypatch.setattr(sampler, "_captures", lambda *a: now["graphs"] and real_rule(*a))

    def call(name, graphs, stop=None, **kw):
        rec = now["rec"] = Record()
        now["graphs"] = graphs
        for c in launch_counters():
            for key in c:
                c[key] = 0
        tracing.take()
        tracing.enable()
        try:
            it = api.clip_guided_diffusion(
                prompts=["a lighthouse in a storm"], weights_mode="random", seed=1234567891,
                device=str(dev), progress=False, prefix_path=tmp_path / name, **kw)
            frames = 0
            for batch_idx, _ in it:
                frames += batch_idx == kw.get("batch_size", 1) - 1
                if frames == stop:
                    break
            it.close()
        finally:
            tracing.disable()
            rec.spans = [s for s in tracing.take() if s.name in ("step", "step.capture")]
        torch.cuda.synchronize(dev)
        rec.launches = {(i, k): n for i, c in enumerate(launch_counters()) for k, n in c.items()}
        now.clear()
        return rec

    return call


def _assert_equal(graphed: Record, eager: Record):
    assert len(graphed.frames) == len(eager.frames) > 0
    for (k, p, x), (ke, pe, xe) in zip(graphed.frames, eager.frames):
        assert k == ke and torch.isfinite(p).all()
        assert torch.equal(p, pe) and torch.equal(x, xe), f"frame of step {k}"
    assert len(graphed.segments) == len(eager.segments) > 0
    for (s, x, g), (se, xe, ge) in zip(graphed.segments, eager.segments):
        assert s == se and np.array_equal(x, xe) and np.array_equal(g, ge), f"segment {s}"
    assert torch.equal(graphed.state, eager.state)
    assert graphed.launches == eager.launches


def _assert_engaged(rec: Record):
    """Every step after its key's first replays its graph, one capture a
    key that ran twice."""
    seen, keys_twice = set(), set()
    steps = sorted((s for s in rec.spans if s.name == "step"), key=lambda s: s.start_ns)
    assert steps
    for s in steps:
        key = (s.counts["guided"], s.counts["cutn"])
        assert s.counts["graph"] == int(key in seen), (s.counts, key)
        if key in seen:
            keys_twice.add(key)
        seen.add(key)
    captures = [s for s in rec.spans if s.name == "step.capture"]
    assert sorted((c.counts["guided"], c.counts["cutn"]) for c in captures) == sorted(keys_twice)
    assert keys_twice


@pytest.mark.parametrize("case", list(CASES))
def test_the_graphed_loop_is_bit_equal_to_the_eager_loop(run, monkeypatch, case):
    kw, stop = CASES[case]
    if case == "init-lpips-augs":
        from cgd_tpu_torch.io_utils import images

        rs = np.random.RandomState(3)
        with open("init.png", "wb") as f:  # in the test's directory, the API's working one
            f.write(images.encode_png(rs.randint(0, 256, (256, 256, 3)).astype(np.uint8)))
        kw = dict(kw, init_image="init.png")
    if case == "remat":
        monkeypatch.setenv("CGD_TPU_REMAT", "1")
    eager = run("eager", False, stop, **kw)
    graphed = run("graphed", True, stop, **kw)
    _assert_equal(graphed, eager)
    _assert_engaged(graphed)
    assert all(s.counts["graph"] == 0 for s in eager.spans if s.name == "step")


def test_recorded_noise_replays_through_the_graph(run, tmp_path):
    """An ancestral 256px run whose step noise comes from a noise file: the
    override is copied into the graph's static noise after the draw."""
    rs = np.random.RandomState(5)
    np.savez(tmp_path / "noise.npz", init=rs.randn(1, 256, 256, 3).astype(np.float32),
             steps=rs.randn(20, 1, 256, 256, 3).astype(np.float32))
    kw = dict(CELL256, timestep_respacing="20", noise_file=str(tmp_path / "noise.npz"))
    eager = run("eager", False, **kw)
    graphed = run("graphed", True, **kw)
    _assert_equal(graphed, eager)
    _assert_engaged(graphed)


def test_a_resume_from_mid_run_replays_as_the_uninterrupted_eager_run(run, tmp_path):
    """A graphed run stopped after its second frame (its checkpoint at that
    segment end), then resumed graphed: its frames, segment ends and final
    generator state are the uninterrupted eager run's from there on."""
    ckpt = str(tmp_path / "state.npz")
    eager = run("eager", False, **CELL256)
    first = run("first", True, stop=2, checkpoint_path=ckpt, **CELL256)
    assert [f[0] for f in first.frames] == [0, 5]
    rest = run("rest", True, resume_from=ckpt, checkpoint_path=ckpt, **CELL256)
    n = len(first.segments)
    tail = Record()
    tail.frames, tail.segments, tail.state = eager.frames[2:], eager.segments[n:], eager.state
    rest.launches = tail.launches = {}
    _assert_equal(rest, tail)
    _assert_engaged(rest)


def test_calls_leave_no_graph_or_pool_behind(run, dev):
    """Three graphed calls back to back leave the card's allocated memory
    where the first leaves it."""
    kw = dict(SHORT, timestep_respacing="ddim6")
    after = []
    for i in range(3):
        rec = run(f"call{i}", True, **kw)
        _assert_engaged(rec)
        del rec
        gc.collect()
        torch.cuda.synchronize(dev)
        after.append(torch.cuda.memory_allocated(dev))
    assert after[0] == after[1] == after[2], after


def test_a_call_given_a_device_lock_stays_eager_beside_other_device_work(run, dev):
    """The daemon's pipelined requests: another thread allocates, copies and
    synchronizes on the card throughout the call, which runs every step
    eagerly and completes, as does the other thread."""
    import threading

    stop, errors = threading.Event(), []

    def churn():
        try:
            while not stop.is_set():
                a = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
                float((torch.randn(1 << 16).to(dev) * 2).sum())
                torch.cuda.synchronize(dev)
                del a
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    other = threading.Thread(target=churn)
    other.start()
    try:
        rec = run("shared", True, device_lock=threading.Lock(), **SHORT)
    finally:
        stop.set()
        other.join(timeout=60)
    assert not other.is_alive() and not errors, errors
    steps = [s for s in rec.spans if s.name == "step"]
    assert len(steps) == 10 and all(s.counts["graph"] == 0 for s in steps)
    assert rec.frames and all(torch.isfinite(p).all() for _, p, _ in rec.frames)
