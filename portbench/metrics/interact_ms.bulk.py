"""Device ms a bulk step in the interaction: the port's stage span
``dlrm.interaction`` (``interaction_features``), CUDA events on the
stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "dlrm.interaction", "bulk")
