"""Device time of the Adam update per train step, in ms: the CUDA events
of the program's ``train.adam`` span (``Engine.apply_gradients``) in the
profiled window, over its ``train.step`` spans."""
from portbench import program_spans


def read(rec):
    return program_spans.per_top("train.adam", "train.step")
