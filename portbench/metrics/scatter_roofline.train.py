"""The backward scatter's (``ct_scatter.cu``: its tile and span kernels)
share of its roofline in the train window: the least time of each step's
call (its bytes counted from the batch's ids, one run a distinct row) over
the kernels' time in the trace, in %."""
from portbench.counts import dlrm as C

KERNEL = r"ct_scatter_(tiles|spans)"


def read(ctx):
    r = ctx.run
    if r.mode != "train" or ctx.summary is None or ctx.cfg["multi_hot"] == 1:
        return None
    t = ctx.summary.device_s(KERNEL)
    if t <= 0:
        return None
    least = 0.0
    for b, used in zip(r.batches, r.used):
        n = C.batch_counts(ctx.cfg, b["sparse"])
        least += used * C.bound_s(*C.scatter_bytes_ops(ctx.cfg, r.batch, **n))
    return 100.0 * least / t
