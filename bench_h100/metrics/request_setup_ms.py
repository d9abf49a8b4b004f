"""request_setup_ms: the median, over the requests begun inside the window,
of the ms from the API call to its "compile + first sampling segment"
progress mark (``stall_pet``): the weights read, the models built, the
prompts encoded. Host clock; nothing where no request began in the window."""

import statistics


def read(ctx):
    ms = [r.setup_ms for r in ctx.requests if r.in_window and r.setup_ms is not None]
    return statistics.median(ms) if ms else None
