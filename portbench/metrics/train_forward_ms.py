"""Device time of the train-mode forward per train step, in ms: the CUDA
events of the program's ``train.forward`` span (the detector's forward,
with its ``detector.*`` spans) in the profiled window, over its
``train.step`` spans."""
from portbench import program_spans


def read(rec):
    return program_spans.per_top("train.forward", "train.step")
