"""Device ms a bulk step in the lookup: the port's stage span
``dlrm.lookup`` (the bag sums, or the one-hot rows, ``where`` and gather,
and the cast of the rows to the model's dtype), CUDA events on the
stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "dlrm.lookup", "bulk")
