"""Samples trained a second in the train window: all samples of the
window's steps over the window's length by the host clock, from the first
call to the end of the last step on the card."""


def read(ctx):
    r = ctx.run
    return r.samples / r.window_s if r.mode == "train" else None
