"""glue_device_ms_per_step: device ms per guided step, in the profiled
stretch, of PyTorch's elementwise, reduction and copy kernels (the glue of
``cgd_tpu_torch/ops/nn.py`` and the models: GroupNorm statistics, casts,
adds, copies), by the kernel names below."""

GLUE = ("elementwise_kernel", "reduce_kernel", "CatArrayBatchedCopy", "Memcpy", "Memset")


def read(ctx):
    s = ctx.stretch
    if not s or not s["steps"] or not s["kernels"]:
        return None
    us = sum(b - a for name, a, b in s["kernels"] if any(g in name for g in GLUE))
    return us / 1e3 / s["steps"]
