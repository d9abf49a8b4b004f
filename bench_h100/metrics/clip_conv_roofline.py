"""clip_conv_roofline: the bound time of the ModifiedResNet image tower's
3x3 convolutions of one guided step (``counts/clip_conv_bound.py``: the
stem's three and one a bottleneck, forward and input gradient over cutn x
batch cutouts, each the larger of FLOPs over the bf16 peak and bytes over
the HBM bandwidth) over the device time per guided step, in the profiled
stretch, of cuDNN's kernels, in %.

cuDNN runs the tower's 3x3s and nothing else of such a step, so its
kernels are those convs' device time, layout transforms included. The
kernels: those whose name holds ``cudnn`` or ``implicit_convolve_sgemm``.
Read off the H100's trace of ``acc512`` (torch 2.11, CUDA 12.8; one guided
step): 42 forwards as ``sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_
f32_nhwckrsc_nhwc_..._5x_cudnn`` and ``cutlass__5x_cudnn::Kernel<
cutlass_tensorop_bf16_s16816fprop_...>``; the stem's first (Cin = 3, on
the cutouts' layout) as ``implicit_convolve_sgemm<__nv_bfloat16, ...>``
with cuDNN's ``nchwToNhwcKernel`` / ``nhwcToNchwKernel`` transforms; 43
input gradients as ``sm90_xmma_dgrad_implicit_gemm_..._5x_cudnn`` (the
stride-2 one ``..._dgrad_implicit_gemm_indexed_...``) and ``cutlass__5x_
cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_...>``, with their
workspace set-up (``cask_plugin__5x_cudnn::...init_device_workspace_
kernel``). The port's UNet at 512px, forward and input gradient, launches
no kernel of these names (its 3x3s are ``cgd::conv3x3_*``, its 1x1s and
linears matmuls), nor do the tower's 1x1s (matmuls in the port), its
attention pool, the cutouts or the losses; no weight gradient is taken.
"""

KERNELS = ("cudnn", "implicit_convolve_sgemm")


def read(ctx):
    s = ctx.stretch
    flops, bw = ctx.peak("bf16_dense_flops"), ctx.peak("hbm_bytes_per_s")
    if not s or not s["steps"] or flops is None:
        return None
    us = sum(b - a for name, a, b in s["kernels"] if any(k in name for k in KERNELS))
    bound = ctx.count("clip_conv_bound").seconds(ctx.config, ctx.traffic["call"], flops, bw)
    if us <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (us / 1e6 / s["steps"])
