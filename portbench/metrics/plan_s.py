"""Host seconds of the partition plan at set-up: the port's set-up span
``setup.plan`` (``non_uniform_partition`` or ``uniform_partition``)."""
from portbench import program_spans


def read(ctx):
    return program_spans.host_s(ctx, "setup.plan")
