"""The ``acc512`` cell's counts and its ``clip_conv_roofline`` reader on the
CPU: the ModifiedResNet's convs of ``counts/clip_conv_bound.py`` against
the shapes walked on the meta device through ``reference/clip.py``, the
bound against its definition, and the reader against a synthetic stretch
of kernels with the names the H100's trace of the cell holds."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from bench_h100.counts import clip_conv_bound, guided_step_flops
from bench_h100.harness import trace
from bench_h100.harness.cells import Cell, peak
from bench_h100.reference.clip import CLIPModel
from bench_h100.reference.layers import Conv2d
from bench_h100.tests import toy
from bench_h100.tests.test_bench_h100_counts import RESNET

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
H100 = "NVIDIA H100 80GB HBM3"

FPROP = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
         "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn")
DGRAD = ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128x64_"
         "warpgroupsize2x1x1_g1_execute_segment_k_off_kernel__5x_cudnn")
STEM = ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_"
        "32x4_nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_"
        "align8::Params)")
GEMM = "nvjet_tst_192x192_64x3_2x1_v_ssched_bz_coopB_NNN"
UNET_CONV = "void cgd::conv3x3_dx_kernel<256>(cgd::ConvMaps, __nv_bfloat16 const*)"
NCHW_CONV = ("void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 1024, 5, 5, 3, 3, 3, 1, "
             "false, false, true>(int, int, int)")
GLUE = ("void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::"
        "BFloat16>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>)")
LAYOUT = ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, "
          "false, true, (cudnnKernelDataType_t)0>(cudnn::engines_precompiled::nchw2nhwc_params_t)")


def _config(name="adm512c-rn50x16"):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _walked(vision, n):
    """(cin, cout, k, res_in, res_out) of every conv of the reference tower's
    forward on the meta device."""
    seen = []
    clip = dict(embed_dim=16, vision=vision,
                text=dict(context_length=77, vocab_size=49408, width=32, heads=2, layers=1))
    with torch.device("meta"):
        visual = CLIPModel(clip).visual

        def hook(mod, inp, out):
            w = mod.weight
            seen.append((w.shape[1], w.shape[0], w.shape[-1], inp[0].shape[-1], out.shape[-1]))

        for m in visual.modules():
            if isinstance(m, Conv2d):
                m.register_forward_hook(hook)
        r = vision["resolution"]
        visual(torch.empty(n, 3, r, r))
    return seen


@pytest.mark.parametrize("vision", [_config()["clip"]["vision"], RESNET["vision"]],
                         ids=["RN50x16", "toy"])
def test_the_conv_list_walks_the_tower(vision):
    counted = [(c["cin"], c["cout"], c["k"], c["res_in"], c["res_out"])
               for c in clip_conv_bound.convs(vision, 2)]
    walked = _walked(vision, 2)
    assert len(counted) == len(walked)
    assert sorted(counted) == sorted(walked)  # the skip's projection runs after conv3
    assert all(c["batch"] == 2 for c in clip_conv_bound.convs(vision, 2))


def test_the_rn50x16_tower_has_127_convs_43_of_them_3x3():
    convs = clip_conv_bound.convs(_config()["clip"]["vision"], 16)
    assert len(convs) == 127 and sum(c["k"] == 3 for c in convs) == 43
    assert clip_conv_bound.convs(_config("adm256u-vitb32")["clip"]["vision"], 16) == []


def test_the_bound_is_the_3x3s_larger_of_flops_and_bytes():
    cfg, call = _config(), dict(num_cutouts=16, batch_size=1)
    secs = clip_conv_bound.seconds(cfg, call, 989e12, 3.35e12)
    assert secs == pytest.approx(2.6352e-3, rel=1e-4)
    flops = sum(2 * 2 * c["batch"] * c["res_out"] ** 2 * 9 * c["cin"] * c["cout"]
                for c in clip_conv_bound.convs(cfg["clip"]["vision"], 16) if c["k"] == 3)
    assert clip_conv_bound.seconds(cfg, call, 1e12, 1e30) == pytest.approx(flops / 1e12)
    fast_mem = clip_conv_bound.seconds(cfg, call, 1e12, 1e30)
    fast_math = clip_conv_bound.seconds(cfg, call, 1e30, 1e12)
    both = clip_conv_bound.seconds(cfg, call, 1e12, 1e12)
    assert max(fast_mem, fast_math) <= both <= fast_mem + fast_math
    assert clip_conv_bound.seconds(cfg, dict(call, batch_size=2), 1e12, 1e30) == pytest.approx(
        2 * fast_mem)
    assert clip_conv_bound.seconds(_config("adm256u-vitb32"), call, 989e12, 3.35e12) == 0.0


def test_the_acc512_step_flops_and_the_towers_share():
    """12.64 TFLOP a step; the RN50x16 tower over 16 cutouts of 384^2 is
    37% of it."""
    cell = Cell(ROOT, "acc512")
    total = guided_step_flops.flops(cell.config, cell.traffic["call"])
    acc = guided_step_flops.Flops()
    guided_step_flops.clip_image(acc, cell.config["clip"], 16)
    assert 12.6e12 < total < 12.7e12
    assert 0.36 < acc.total / total < 0.38


def test_the_cell_is_acceptance_configuration_4():
    cell = Cell(ROOT, "acc512")
    call = cell.traffic["call"]
    assert cell.config["unet"]["image_size"] == 512 and cell.config["unet"]["class_cond"]
    assert cell.config["clip"]["name"] == "RN50x16"
    assert (call["timestep_respacing"], call["num_cutouts"], call["clip_guidance_scale"],
            call["tv_scale"], call["batch_size"]) == ("1000", 16, 1500, 150, 1)
    assert call["randomize_class"] is True and cell.traffic["window"]["close"] == "frame"
    assert "frame_mad_s0" in cell.limits
    names = {m["name"] for m in cell.metrics(True)}
    assert "clip_conv_roofline" in names and "request_setup_ms" not in names
    assert "clip_conv_roofline" not in {m["name"] for m in Cell(ROOT, "cog256").metrics(True)}


def _ctx(kernels, steps=2):
    cell = Cell(ROOT, "acc512")
    s = trace.summarize(kernels, [], 1.0, steps) if kernels is not None else None
    return SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, stretch=s,
                           count=cell.count, peak=lambda key: peak(ROOT, H100, key))


def _read(ctx):
    return Cell(ROOT, "acc512").reader("clip_conv_roofline")(ctx)


def test_the_reader_counts_cudnns_kernels_alone():
    # per step: 3.2 ms of cuDNN's kernels (the tower's 3x3s, their layout
    # transforms) amid the UNet's conv kernels, the GEMMs and the glue
    step = [(FPROP, 0, 1000), (GEMM, 1000, 2000), (DGRAD, 2000, 3500), (STEM, 3500, 4000),
            (UNET_CONV, 4000, 9000), (NCHW_CONV, 9000, 9100), (LAYOUT, 9100, 9200),
            (GLUE, 9200, 9900)]
    kernels = step + [(n, a + 10000, b + 10000) for n, a, b in step]
    bound = clip_conv_bound.seconds(_config(), dict(num_cutouts=16, batch_size=1), 989e12,
                                    3.35e12)
    assert _read(_ctx(kernels)) == pytest.approx(100.0 * bound / 3.2e-3)


@pytest.mark.parametrize("kernels", [None, [], [(GEMM, 0, 10), (UNET_CONV, 10, 20),
                                                (GLUE, 20, 30)]],
                         ids=["no stretch", "no kernels", "no cudnn kernel"])
def test_the_reader_gives_none_with_nothing_to_read(kernels):
    assert _read(_ctx(kernels)) is None


def test_the_reader_gives_none_for_a_vit_tower():
    ctx = _ctx([(FPROP, 0, 1000)])
    cell = Cell(ROOT, "cog256")
    ctx.config, ctx.traffic, ctx.count = cell.config, cell.traffic, cell.count
    assert _read(ctx) is None


def test_a_run_without_a_device_trace_leaves_the_metric_out(tmp_path, monkeypatch):
    """The harness's whole traced run on the CPU, at toy widths, with the
    metric listed for the toy cell: the CPU has no device trace, so the line
    leaves it out, and the run stays correct."""
    root = toy.make_root(tmp_path)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] == "clip_conv_roofline":
            m["workloads"].append("toy")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res = toy.run(monkeypatch, tmp_path, root, seconds=0.3, trace=True)
    assert res["correct"] is True and "clip_conv_roofline" not in res["metrics"]
