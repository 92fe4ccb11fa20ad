"""The cross network's share of its roofline in the bulk window: the
stage's least time (its operations at the fp32 peak against its bytes,
``cross_bytes_ops`` of the configuration model's counts,
``portbench/counts/<model>.py``) over the device time of its stage span
``dlrm.cross`` a step, in %. None where the model's counts have no cross
network or the run has no such span."""
from portbench import drive, program_spans


def read(ctx):
    r = ctx.run
    if r.mode != "bulk":
        return None
    C = drive.load("counts", ctx.cfg["model"])
    count = getattr(C, "cross_bytes_ops", None)
    ms = None if count is None else program_spans.stage_ms(
        ctx, "dlrm.cross", "bulk")
    if not ms:
        return None
    return 100.0 * C.bound_s(*count(ctx.cfg, r.batch)) / (ms * 1e-3)
