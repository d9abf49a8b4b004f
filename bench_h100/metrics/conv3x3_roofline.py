"""conv3x3_roofline: the bound time of the UNet's 3x3 convolutions of one
guided step (``counts/conv3x3_bound.py``: forward and input gradient, each
the larger of FLOPs over the bf16 peak and bytes over the HBM bandwidth)
over the device time per guided step, in the profiled stretch, of the
kernels that do them (the bf16 ``cgd::conv3x3`` family below), in %."""

KERNELS = ("cgd::conv3x3_",)


def read(ctx):
    s = ctx.stretch
    flops, bw = ctx.peak("bf16_dense_flops"), ctx.peak("hbm_bytes_per_s")
    if not s or not s["steps"] or flops is None:
        return None
    us = sum(b - a for name, a, b in s["kernels"] if any(k in name for k in KERNELS))
    if us <= 0:
        return None
    bound = ctx.count("conv3x3_bound").seconds(ctx.config, ctx.traffic["call"], flops, bw)
    return 100.0 * bound / (us / 1e6 / s["steps"])
