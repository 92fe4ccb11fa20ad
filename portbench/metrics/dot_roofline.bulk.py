"""The interaction kernel's (``dot_interaction.cu``, either geometry) share
of its roofline in the bulk window: the least time of its fused entry's
calls, one a step, over its time in the trace, in %."""
from portbench.counts import dlrm as C

KERNEL = r"dot_interaction_kernel|dot_tiled_kernel"


def read(ctx):
    r = ctx.run
    if r.mode != "bulk" or ctx.summary is None:
        return None
    t = ctx.summary.device_s(KERNEL)
    if t <= 0:
        return None
    least = r.steps * C.bound_s(*C.dot_bytes_ops(ctx.cfg, r.batch))
    return 100.0 * least / t
