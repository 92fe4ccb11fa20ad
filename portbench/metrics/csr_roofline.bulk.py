"""The CSR bag kernel's (``csr_bag.cu``; the fp32-output instance in the
DLRM-DCNv2 cell) share of its roofline in the bulk window: the least time
of each step's call (``csr_bytes_ops`` of the configuration model's
counts, ``portbench/counts/<model>.py``, its bytes counted from the
batch's ids, each distinct row once) over the kernel's time in the trace,
in %. None where the model's counts have no CSR lookup or the kernel did
not run."""
from portbench import drive

KERNEL = r"csr_bag_kernel"


def read(ctx):
    r = ctx.run
    if r.mode != "bulk" or ctx.summary is None:
        return None
    C = drive.load("counts", ctx.cfg["model"])
    count = getattr(C, "csr_bytes_ops", None)
    t = ctx.summary.device_s(KERNEL)
    if count is None or t <= 0:
        return None
    least = 0.0
    for b, used in zip(r.batches, r.used):
        n = C.batch_counts(ctx.cfg, b["sparse"])
        least += used * C.bound_s(*count(ctx.cfg, r.batch, **n))
    return 100.0 * least / t
