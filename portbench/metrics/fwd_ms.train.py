"""Device ms a train step in the forward pass and the loss: the port's
stage span ``train.forward``, CUDA events on the stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "train.forward", "train")
