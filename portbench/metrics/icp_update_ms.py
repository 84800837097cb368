"""Device time of ICP's updates per batch, in ms: the CUDA events of the
program's ``icp.update`` spans (one an iteration: the inlier weights,
the gather, the batched Kabsch and the selects) in the profiled window,
over its ``icp.batch`` spans."""
from portbench import program_spans


def read(rec):
    return program_spans.per_top("icp.update", "icp.batch")
