"""The port's tracer (``cgd_tpu_torch/utils/tracing.py``), its spans in a
toy run of the API, and the reductions of ``tools/span_report.py``, on the
CPU (toy models: CGD_TPU_DEBUG_TINY=1, random weights, 64px, f32).

- With tracing off ``span`` returns the one shared no-op object and nothing
  is recorded, in a whole API call too; ``take()`` clears what it returns.
- Parents nest per thread; a generator's span leaves the stack at its yield.
- One API call gives one ``api.request`` tree with the spans its layers
  open, all under one request id; two calls give two.
- The clock: an operator that ``torch.profiler`` records inside a span has
  its kineto start and end inside the span's interval.
- ``guidance.clip`` opens once inside each guided step's ``step.guidance``
  with the tower's counts, ``step.update`` says whether the update is
  ancestral, and the report gives the tower's ms a step and its idle.
- A step says whether it replayed a CUDA graph (``graph``, 0 on the CPU);
  the report reads the host's step time over eager steps alone, the share
  of steps replayed and the median ``step.capture``.
"""

import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch import api as tapi  # noqa: E402
from cgd_tpu_torch import weights as tweights  # noqa: E402
from cgd_tpu_torch.tools import span_report  # noqa: E402
from cgd_tpu_torch.utils import pytree_io, tracing  # noqa: E402

torch.set_num_threads(2)

KW = dict(prompts=["a red cube"], image_size=64, num_cutouts=2, timestep_respacing="ddim5",
          weights_mode="random", device="cpu", compute_dtype="float32", progress=False)
PHASES = {"step.unet", "step.guidance", "step.backward", "step.update"}


@pytest.fixture
def tracer():
    tracing.take()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.take()


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_off_returns_the_shared_no_op_and_records_nothing():
    a, b = tracing.span("x", n=1), tracing.request("y")
    assert a is tracing.NO_SPAN and b is tracing.NO_SPAN
    with a as sp:
        sp.note(n=2)
    with tracing.detached(b):
        pass
    assert tracing.take() == []


def test_take_returns_the_finished_spans_and_clears_them(tracer):
    with tracer.span("a", n=3) as sp:
        sp.note(bytes=7)
        time.sleep(0.001)
    (got,) = tracer.take()
    assert got.name == "a" and got.counts == {"n": 3, "bytes": 7}
    assert got.parent is None and got.request is None
    assert got.end_ns - got.start_ns >= 1_000_000
    assert tracer.take() == []


def test_parents_nest_per_thread(tracer):
    seen = {}

    def other():
        with tracer.span("b") as b:
            with tracer.span("c") as c:
                seen.update(b=b, c=c)

    with tracer.request("a") as a:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with tracer.span("d") as d:
            pass
    assert seen["b"].parent is None and seen["c"].parent == seen["b"].id
    assert seen["b"].request is None and seen["b"].thread != a.thread
    assert d.parent == a.id and d.request == a.request is not None
    assert {s.name for s in tracer.take()} == {"a", "b", "c", "d"}


def test_a_generator_span_leaves_the_stack_at_its_yield(tracer):
    def gen():
        with tracer.request("g") as g:
            for i in range(2):
                with tracer.span("inner"):
                    pass
                with tracer.detached(g):
                    yield i

    it = gen()
    next(it)
    with tracer.span("caller") as caller:
        pass
    list(it)
    spans = {s.id: s for s in tracer.take()}
    g = next(s for s in spans.values() if s.name == "g")
    assert caller.parent is None and caller.request is None
    assert g.start_ns < caller.start_ns < caller.end_ns < g.end_ns
    assert [s.parent for s in spans.values() if s.name == "inner"] == [g.id, g.id]


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def test_a_toy_call_gives_one_request_tree(tracer, tiny):
    gaps = []
    for _ in tapi.clip_guided_diffusion(**KW, batch_size=2, save_frequency=2,
                                        prefix_path=tiny / "a"):
        t0 = time.time_ns()
        time.sleep(0.01)  # the caller's own time at a yield
        gaps.append((t0, time.time_ns()))
    spans = tracer.take()
    kids = _children(spans)
    (root,) = kids[None]
    assert root.name == "api.request" and root.counts == {"batch": 2, "steps": 5}
    assert {s.request for s in spans} == {root.request}
    top = [s.name for s in sorted(kids[root.id], key=lambda s: s.start_ns)]
    assert top[:2] == ["api.models", "api.prompts"]
    models = next(s for s in kids[root.id] if s.name == "api.models")
    assert models.counts == {"hits": 0, "misses": 0}  # random weights are never kept
    built = kids[models.id]
    assert [s.name for s in built] == ["weights.build", "weights.build"]
    assert {s.counts["model"] for s in built} == {"ViT-B/32", "64x64_diffusion.pt"}
    segs = [s for s in kids[root.id] if s.name == "loop.segment"]
    steps = [s for g in segs for s in kids[g.id]]
    assert [s.counts["k"] for s in steps] == [0, 1, 2, 3, 4]
    assert all(s.name == "step" and s.counts["guided"] and s.counts["cutn"] == 2 for s in steps)
    assert all(s.counts["graph"] == 0 for s in steps)  # eager on the CPU
    for s in steps:
        assert {c.name for c in kids[s.id]} == PHASES
        assert all(c.parent == s.id for c in kids[s.id])
    writes = [s for s in kids[root.id] if s.name == "images.write"]
    assert sorted(s.counts["k"] for s in writes) == [0, 0, 2, 2, 4, 4]  # 2 images, 3 saves
    assert all(s.counts["bytes"] > 0 for s in writes)
    assert len([s for s in kids[root.id] if s.name == "images.to_host"]) == 3
    # the caller's time lies inside the request and inside no child span
    others = [s for s in spans if s is not root]
    for a, b in gaps:
        assert root.start_ns < a and b <= root.end_ns
        assert not any(s.start_ns < b and a < s.end_ns for s in others)
    list(tapi.clip_guided_diffusion(**KW, prefix_path=tiny / "b"))
    second = {s.request for s in tracer.take()}
    assert len(second) == 1 and second != {root.request}


def test_an_untraced_call_records_no_spans(tiny):
    list(tapi.clip_guided_diffusion(**KW, prefix_path=tiny / "a"))
    assert tracing.take() == []


def test_the_weights_spans_of_a_cached_checkpoint(tracer, tmp_path):
    module = torch.nn.Linear(3, 2)
    path = str(tmp_path / "lin.pt.npz.cgd")
    pytree_io.save_flat(path, {k: v.numpy() for k, v in module.state_dict().items()})
    flat = tweights._cached(path, None, "lin")
    out = tweights._on_device(lambda: torch.nn.Linear(3, 2), flat, "cpu", "lin")
    assert torch.equal(out.weight, module.weight)
    spans = tracer.take()
    assert [s.name for s in spans] == ["weights.read", "weights.build", "weights.load",
                                       "weights.to_device"]
    size = (tmp_path / "lin.pt.npz.cgd").stat().st_size
    assert spans[0].counts == {"model": "lin", "bytes": size}
    assert all(s.counts["model"] == "lin" for s in spans)


def test_a_profiled_operator_lies_inside_its_span_on_one_clock(tracer):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("mm") as sp:
            torch.mm(a, a)
    kr = prof.profiler.kineto_results
    (e,) = [e for e in kr.events() if e.name() == "aten::mm"]
    assert sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns
    # the profiler's own times are µs from the trace's start on that clock
    (f,) = [f for f in prof.events() if f.name == "aten::mm"]
    assert abs(kr.trace_start_ns() + f.time_range.start * 1e3 - e.start_ns()) <= 1e3


def _d(name, sid, parent, a_ms, b_ms, request=1, thread=1, **counts):
    return dict(name=name, id=sid, parent=parent, request=request, thread=thread,
                start_ns=int(a_ms * 1e6), end_ns=int(b_ms * 1e6), counts=counts)


# two requests: the first begun before the window [100, 1000) ms, the second in it
RECORDED = [
    _d("api.request", 1, None, 0, 500),
    _d("api.models", 2, 1, 0, 60, hits=0, misses=2),
    _d("weights.read", 3, 2, 0, 20, model="m", bytes=2e9),
    _d("step", 4, 1, 150, 350, k=0, guided=True, cutn=16),
    _d("step.unet", 5, 4, 150, 200),
    _d("step.guidance", 6, 4, 200, 230),
    _d("step.backward", 7, 4, 230, 330),
    _d("step.update", 8, 4, 330, 345),
    _d("images.to_host", 9, 1, 350, 360, k=0),
    _d("images.write", 10, 1, 360, 380, k=0, bytes=10),
    _d("images.write", 11, 1, 385, 395, k=0, bytes=10),
    _d("api.request", 20, None, 500, 990, request=2),
    _d("api.models", 21, 20, 500, 580, request=2, hits=2, misses=0),
    _d("step", 22, 20, 600, 700, request=2, k=0, guided=True, cutn=16),
    _d("step", 23, 20, 700, 760, request=2, k=1, guided=False, cutn=16),
    _d("images.write", 24, 20, 800, 812, request=2, k=1, bytes=10),
]


def test_the_reductions_read_recorded_spans():
    ms = 1_000_000
    lo, hi = 100 * ms, 1000 * ms
    assert span_report.weights_load_ms(RECORDED, lo, hi) == 80.0
    assert span_report.weights_load_ms(RECORDED) == 70.0
    assert span_report.models_hit_share(RECORDED, lo, hi) == 1.0
    assert span_report.models_hit_share(RECORDED) == 0.5  # (0 + 2) of (2 + 2)
    assert span_report.step_host_ms(RECORDED, lo, hi) == 150.0
    assert span_report.step_host_ms(RECORDED, lo, hi, outside=(600 * ms, 650 * ms)) == 200.0
    assert span_report.frame_write_ms(RECORDED, lo, hi) == 21.0  # (30 + 12) / 2
    phases = span_report.step_phases_ms(RECORDED, lo, 400 * ms)
    assert phases == {"step.unet": 50.0, "step.guidance": 30.0, "step.backward": 100.0,
                      "step.update": 15.0, "step.self": 5.0}
    assert span_report.read_gb_per_s(RECORDED) == pytest.approx(100.0)
    # device busy [150, 200) and [330, 345) ms of the stretch [150, 400)
    device = [(150 * ms, 200 * ms), (330 * ms, 345 * ms)]
    lo, hi = 150 * ms, 400 * ms
    assert span_report.idle_in_step_pct(RECORDED, device, lo, hi) == pytest.approx(
        100.0 * (130 + 5) / 250)
    by = span_report.idle_by_span(RECORDED, device, lo, hi)
    assert by == pytest.approx({"step.backward": 0.1, "step.guidance": 0.03,
                                "images.write": 0.03, "images.to_host": 0.01,
                                "api.request": 0.01, "step": 0.005, "no span": 0.0})
    assert sum(by.values()) == pytest.approx(0.185)  # the idle time, all of it named


def test_the_replayed_steps_and_their_captures():
    """``step_host_ms`` and the phase split read eager steps alone (a
    replayed step's span times one graph launch); the share of steps
    replayed and the median capture are read beside them."""
    ms = 1_000_000
    recorded = [
        _d("step", 1, None, 0, 200, k=0, guided=True, cutn=16, graph=0),
        _d("step.unet", 2, 1, 0, 50),
        _d("step", 3, None, 200, 500, k=1, guided=True, cutn=16, graph=1),
        _d("step.capture", 4, 3, 200, 450, guided=True, cutn=16),
        _d("step.unet", 5, 4, 200, 260),
        _d("step", 6, None, 500, 502, k=2, guided=True, cutn=16, graph=1),
        _d("step", 7, None, 502, 504, k=3, guided=True, cutn=16, graph=1),
        _d("step", 8, None, 504, 704, k=4, guided=True, cutn=8, graph=0),
        _d("step", 9, None, 704, 804, k=5, guided=True, cutn=8, graph=1),
        _d("step.capture", 10, 9, 704, 794, guided=True, cutn=8),
    ]
    assert span_report.step_host_ms(recorded) == 200.0
    assert span_report.step_phases_ms(recorded)["step.unet"] == 25.0  # (50 + 0) / 2
    assert span_report.replayed_share(recorded) == pytest.approx(4 / 6)
    assert span_report.replayed_share(recorded, 500 * ms, 504 * ms) == 1.0
    assert span_report.capture_ms(recorded) == 170.0  # (250 + 90) / 2
    assert span_report.capture_ms(recorded, 0, 500 * ms) == 250.0
    rep = span_report.report(recorded)
    assert rep["replayed_share"] == pytest.approx(4 / 6) and rep["capture_ms"] == 170.0


@pytest.mark.parametrize("reduce", [
    lambda s: span_report.weights_load_ms(s, 0, 1),
    lambda s: span_report.step_host_ms(s),
    lambda s: span_report.frame_write_ms(s, 0, 1),
    lambda s: span_report.idle_in_step_pct(s, [], 0, 10),
    lambda s: span_report.read_gb_per_s(s),
    lambda s: span_report.models_hit_share(s),
    lambda s: span_report.clip_ms_per_step(s),
    lambda s: span_report.replayed_share(s),
    lambda s: span_report.capture_ms(s),
], ids=["weights_load_ms", "step_host_ms", "frame_write_ms", "idle_in_step_pct",
        "read_gb_per_s", "models_hit_share", "clip_ms_per_step", "replayed_share", "capture_ms"])
def test_each_reduction_reads_none_from_nothing(reduce):
    assert reduce([]) is None
    assert reduce([_d("api.prompts", 1, None, 5, 6)]) is None


@pytest.mark.parametrize("respacing,ancestral", [("ddim5", 0), ("5", 1)],
                         ids=["ddim", "ancestral"])
def test_the_clip_tower_span_and_the_update_kind(tracer, tiny, respacing, ancestral):
    """``guidance.clip`` opens once in each guided step's ``step.guidance``,
    with the tower's kind, the images it encodes (cutouts times batch) and
    its input side; ``step.update`` says whether the update is ancestral."""
    list(tapi.clip_guided_diffusion(**dict(KW, timestep_respacing=respacing), batch_size=2,
                                    prefix_path=tiny / "a"))
    spans = tracer.take()
    kids = _children(spans)
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == 5 and all(s.counts["guided"] for s in steps)
    for s in steps:
        (guidance,) = [c for c in kids[s.id] if c.name == "step.guidance"]
        (clip,) = kids[guidance.id]
        assert clip.name == "guidance.clip"
        assert clip.counts == {"tower": "vit", "images": 4, "resolution": 224}
        assert guidance.start_ns <= clip.start_ns <= clip.end_ns <= guidance.end_ns
        (update,) = [c for c in kids[s.id] if c.name == "step.update"]
        assert update.counts == {"ancestral": ancestral}
    assert sum(s.name == "guidance.clip" for s in spans) == 5


def test_the_clip_tower_time_a_step_and_its_idle():
    ms = 1_000_000
    recorded = RECORDED + [_d("guidance.clip", 30, 6, 205, 225, tower="resnet", images=16,
                              resolution=384)]
    assert span_report.clip_ms_per_step(recorded, 100 * ms, 400 * ms) == 20.0
    assert span_report.clip_ms_per_step(recorded, 500 * ms, 1000 * ms) is None
    assert span_report.clip_ms_per_step(RECORDED) is None
    # the device busy [150, 210) ms of [150, 260): idle 15 ms under the
    # tower, 5 + 30 under step.guidance
    rep = span_report.report(recorded, [(150 * ms, 210 * ms)], 150 * ms, 260 * ms)
    assert rep["clip_ms_per_step"] == 20.0
    assert rep["idle_s_by_span"]["guidance.clip"] == pytest.approx(0.015)
    assert rep["idle_s_by_span"]["step.backward"] == pytest.approx(0.030)
    assert rep["idle_s_by_span"]["step.guidance"] == pytest.approx(0.005)


def test_innermost_names_each_piece_by_the_latest_begun_span():
    got = span_report.innermost(RECORDED[:11])
    assert got[:4] == [(0, 20 * 10**6, "weights.read"), (20 * 10**6, 60 * 10**6, "api.models"),
                       (60 * 10**6, 150 * 10**6, "api.request"),
                       (150 * 10**6, 200 * 10**6, "step.unet")]
    assert span_report.innermost(RECORDED, thread=2) == []


def test_spans_join_a_chrome_trace_on_its_clock(tracer, tmp_path):
    with tracer.request("api.request", batch=1):
        with tracer.span("images.write", k=0, bytes=5):
            pass
    spans = tracer.take()
    base = spans[0].start_ns - 2000
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": 1.0, "dur": 0.5}]}))
    tracing.add_to_chrome_trace(path, spans)
    trace = json.loads(path.read_text())
    rows = [e for e in trace["traceEvents"] if e.get("cat") == "cgd_span"]
    assert {e["pid"] for e in rows} == {tracing.CHROME_PID}
    write = next(e for e in rows if e["name"] == "images.write")
    assert write["ts"] == pytest.approx((spans[0].start_ns - base) / 1e3)
    assert write["args"]["k"] == 0 and write["args"]["bytes"] == 5
    back, device = span_report.from_chrome_trace(trace)
    assert device == [(base + 1000, base + 1500)]
    assert sorted((d["name"], d["counts"]) for d in back) == [
        ("api.request", {"batch": 1}), ("images.write", {"k": 0, "bytes": 5})]
    one = next(d for d in back if d["name"] == "images.write")
    assert abs(one["start_ns"] - spans[0].start_ns) <= 1 and one["parent"] == spans[1].id


def test_the_report_tool_reads_a_trace(tracer, tmp_path, capsys):
    with tracer.request("api.request", batch=1):
        with tracer.span("api.models", hits=1, misses=1):
            pass
        with tracer.span("step", k=0, guided=True, cutn=2):
            with tracer.span("step.unet"):
                time.sleep(0.002)
    spans = tracer.take()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": spans[0].start_ns,
                                "traceEvents": []}))
    tracing.add_to_chrome_trace(path, spans)
    assert span_report.main([str(path)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["spans"]["step"]["count"] == 1 and rep["step_host_ms"] >= 2.0
    assert rep["step_phases_ms"]["step.unet"] >= 2.0 and "idle_in_step_pct" not in rep
    assert rep["spans"]["step"]["median_ms"] == pytest.approx(rep["step_host_ms"])
    assert rep["models_hit_share"] == 0.5
