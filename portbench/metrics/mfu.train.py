"""The train step's share of the card's fp32 peak: the model's textbook
FLOPs (6 a dense parameter and sample) over the device time of the
window's steps (CUDA events), over the published 67 TFLOP/s, in %."""
from portbench.counts import dlrm as C


def read(ctx):
    r = ctx.run
    if r.mode != "train":
        return None
    flops = C.model_flops(ctx.cfg, r.batch, train=True) * r.steps
    return 100.0 * flops / r.device_s / C.PEAKS["fp32_flops"]
