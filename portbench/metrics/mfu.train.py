"""The train step's share of the card's fp32 peak: a step's textbook FLOPs
as the configuration's model adapter counts them (DLRM: 6 a dense
parameter and sample) over the device time of the window's steps (CUDA
events), over the published 67 TFLOP/s, in %."""
from portbench import drive
from portbench.counts import PEAKS


def read(ctx):
    r = ctx.run
    if r.mode != "train":
        return None
    model = drive.load("models", ctx.cfg["model"])
    flops = model.model_flops(ctx.cfg, r.batch, train=True) * r.steps
    return 100.0 * flops / r.device_s / PEAKS["fp32_flops"]
