"""Seconds from the process's start to the first timed step: imports, the
kernels' load (their build on a first run), the plan, weights and traffic
from the seed on the card, pools, warm-up."""


def read(ctx):
    return ctx.setup_s
