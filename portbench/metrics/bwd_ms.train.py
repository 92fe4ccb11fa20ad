"""Device ms a train step in the backward pass: the port's stage span
``train.backward`` (``torch.autograd.grad``, the lookup's backward
included), CUDA events on the stream."""
from portbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "train.backward", "train")
