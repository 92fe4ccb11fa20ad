"""Device ms a bulk step in the cross network: the port's stage span
``dlrm.cross`` (the concatenation of x and the field sums and every cross
layer's matrix products and multiply-add), CUDA events on the stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "dlrm.cross", "bulk")
