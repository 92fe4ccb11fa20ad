"""Device ms a train step in the optimizer: the port's stage span
``train.optimizer`` (Adam on the MLPs, row-wise Adagrad on the table,
and the apply of the updates), CUDA events on the stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "train.optimizer", "train")
