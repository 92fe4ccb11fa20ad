"""Device ms a bulk step in the top MLP: the port's stage span
``dlrm.top_mlp`` (its matrix products, bias adds and ReLUs), CUDA events
on the stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "dlrm.top_mlp", "bulk")
