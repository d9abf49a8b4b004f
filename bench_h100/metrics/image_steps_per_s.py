"""image_steps_per_s: guided image-steps done in the window over the
window's seconds, each request's set-up and frame writes inside it. Host
clock."""


def read(ctx):
    return ctx.work / ctx.window_s
