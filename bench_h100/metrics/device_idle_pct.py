"""device_idle_pct: the share of the profiled stretch's wall time in which
no device operation ran (the union of their intervals), in %."""


def read(ctx):
    s = ctx.stretch
    if not s or s["wall_s"] <= 0 or not s["kernels"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
