"""Device ms a train step in the bag sums' backward: the port's stage span
``lookup.backward`` (the id sort, the index kernels and the scatter), on
autograd's thread, CUDA events on the stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "lookup.backward", "train")
