"""step_mfu_pct: the guided step's FLOPs (``counts/guided_step_flops.py``)
times the image-steps done in the window outside the profiled stretch,
over those seconds, as a share of the card's bf16 dense peak
(``counts/peaks.json``), in %."""


def read(ctx):
    peak = ctx.peak("bf16_dense_flops")
    if peak is None or ctx.untraced_s <= 0 or ctx.untraced_work <= 0:
        return None
    per_image = ctx.count("guided_step_flops").flops(ctx.config, ctx.traffic["call"]) / ctx.batch
    return 100.0 * per_image * ctx.untraced_work / ctx.untraced_s / peak
