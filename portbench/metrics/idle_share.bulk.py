"""The share of the traced bulk window in which no kernel, copy or memset
ran on the card, in %."""


def read(ctx):
    s = ctx.summary
    if ctx.run.mode != "bulk" or s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
