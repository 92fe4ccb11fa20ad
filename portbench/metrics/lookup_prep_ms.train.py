"""Device ms a train step in the backward scatter's prep: the port's stage
span ``lookup.prep`` (the entries' labels, their sort by slot and the run
table, inside ``lookup.backward``; not the zero fill, not the scatter),
CUDA events on the stream. None where the port has no such span."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "lookup.prep", "train")
