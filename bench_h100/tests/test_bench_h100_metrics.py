"""Each metric reader of ``bench_h100/metrics`` against a small recorded
stretch: device operations with their times and the saved frames' times, as
``harness/trace.py`` reduces a ``torch.profiler`` trace, and the window's
records. A reader that finds nothing to read gives None."""

import json
import os
from types import SimpleNamespace

import pytest

from bench_h100.counts import conv3x3_bound, guided_step_flops
from bench_h100.harness import trace
from bench_h100.harness.cells import Cell, peak

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CONV = "void cgd::conv3x3_fwd_kernel<256, true, false, false, false>(cgd::ConvMaps)"
DX = "void cgd::conv3x3_dx_kernel<256>(cgd::ConvMaps, __nv_bfloat16 const*)"
ADD = "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>>"
RED = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16>>"
COPY = "Memcpy DtoD (Device -> Device)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
F32CONV = "void cgd::f32conv::conv3x3_f32_kernel<64>(CUtensorMap)"
# (name, start us, end us): two guided steps, with idle gaps between them
KERNELS = [(CONV, 0, 1000), (ADD, 1000, 1500), (GEMM, 1400, 3000), (DX, 5000, 6000),
           (RED, 6000, 6200), (COPY, 9000, 9100), (F32CONV, 9100, 9600), (CONV, 12000, 13000),
           (DX, 13500, 14500)]
SAVES = [7000.0, 15000.0]  # saved frames: one in the gap [6200, 9000], one after the last op


def _ctx(cell="cog256", stretch=True, requests=None, gaps=None):
    c = Cell(ROOT, cell)
    s = trace.summarize(KERNELS, SAVES, 0.02, 2) if stretch else None
    name = "NVIDIA H100 80GB HBM3"
    return SimpleNamespace(
        cell=c, config=c.config, traffic=c.traffic, batch=c.traffic["call"]["batch_size"],
        setup_s=21.5, window_s=40.0, work=200, untraced_work=180, untraced_s=36.0,
        gaps_ms=gaps if gaps is not None else [600.0] * 5, requests=requests or [],
        stretch=s, device_name=name, count=c.count, peak=lambda key: peak(ROOT, name, key))


def test_summarize_busy_gaps_and_top_ops():
    s = trace.summarize(KERNELS, SAVES, 0.02, 2)
    # union: [0, 3000] + [5000, 6200] + [9000, 9600] + [12000, 13000] + [13500, 14500]
    assert s["busy_s"] == pytest.approx((3000 + 1200 + 600 + 1000 + 1000) / 1e6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops[CONV] == pytest.approx(2000 / 1e6) and ops[DX] == pytest.approx(2000 / 1e6)
    assert list(ops)[:2] in ([CONV, DX], [DX, CONV])
    gaps = s["breakdown"]["idle_gaps"]
    assert [g for _, g in gaps] == sorted((g for _, g in gaps), reverse=True)
    assert gaps[0] == ["host: frame write", pytest.approx(2800 / 1e6)]
    assert sorted(g for n, g in gaps if n == "host: dispatch") == pytest.approx(
        [500 / 1e6, 2000 / 1e6, 2400 / 1e6])
    assert len(gaps) == 4


def _read(name, ctx):
    return Cell(ROOT, "cog256").reader(name)(ctx)


def test_device_idle_pct():
    assert _read("device_idle_pct", _ctx()) == pytest.approx(100 * (1 - 0.0068 / 0.02))
    assert _read("device_idle_pct", _ctx(stretch=False)) is None


def test_glue_device_ms_per_step():
    # the add, the reduction and the copy; not the GEMM, the convs or the f32 conv
    assert _read("glue_device_ms_per_step", _ctx()) == pytest.approx((500 + 200 + 100) / 1e3 / 2)
    assert _read("glue_device_ms_per_step", _ctx(stretch=False)) is None


def test_conv3x3_roofline():
    ctx = _ctx()
    bound = conv3x3_bound.seconds(ctx.config, ctx.traffic["call"], 989e12, 3.35e12)
    conv_s_per_step = (1000 + 1000 + 1000 + 1000) / 1e6 / 2  # bf16 convs only
    assert _read("conv3x3_roofline", ctx) == pytest.approx(100 * bound / conv_s_per_step)
    assert _read("conv3x3_roofline", _ctx(stretch=False)) is None


def test_step_mfu_pct():
    ctx = _ctx()
    flops = guided_step_flops.flops(ctx.config, ctx.traffic["call"])
    assert _read("step_mfu_pct", ctx) == pytest.approx(100 * flops * 180 / 36.0 / 989e12)
    ctx.peak = lambda key: None  # a card with no published peak: nothing
    assert _read("step_mfu_pct", ctx) is None


def test_request_setup_ms():
    def req(setup, in_window):
        return SimpleNamespace(setup_ms=setup, in_window=in_window)

    ctx = _ctx(requests=[req(9000.0, False), req(6000.0, True), req(6400.0, True),
                         req(None, True)])
    assert _read("request_setup_ms", ctx) == pytest.approx(6200.0)
    assert _read("request_setup_ms", _ctx(requests=[req(9000.0, False)])) is None


def test_end_to_end_readers():
    ctx = _ctx(gaps=[float(g) for g in range(300, 420, 10)])
    assert _read("setup_s", ctx) == 21.5
    assert _read("image_steps_per_s", ctx) == 200 / 40.0


def test_each_metric_has_its_reader_and_its_cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for w in bench["workloads"]:
        c = Cell(ROOT, w["name"])
        e2e = {m["name"] for m in c.metrics(False)}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.metrics(True)
