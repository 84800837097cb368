"""Host time of a train step, in ms: the host clock inside the program's
``train.step`` span, per step of the profiled window.  The profiler's own
host cost (one record per operator launched) inflates it over the
unprofiled step's: read it against the same cell's earlier runs, not
against the step time of the timed window.  None without a card."""
from portbench import program_spans


def read(rec):
    return program_spans.per_top("train.step", "train.step", "host_ms")
