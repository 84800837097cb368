"""Device time of the backward per train step, in ms: the CUDA events of
the program's ``train.backward`` span (``torch.autograd.grad``) in the
profiled window, over its ``train.step`` spans."""
from portbench import program_spans


def read(rec):
    return program_spans.per_top("train.backward", "train.step")
