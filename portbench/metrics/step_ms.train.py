"""Device ms a train step: CUDA events around the window's steps, over the
steps."""


def read(ctx):
    r = ctx.run
    return r.device_s / r.steps * 1e3 if r.mode == "train" else None
