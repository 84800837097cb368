"""Device time of the frustum solve's probe launch per solve, in ms: the
CUDA events of the program's ``frustum.probe`` span (the LM kernel on
every init at the probe's point stride) in the profiled window, over its
``frustum.solve`` spans.  None where the program has no such spans."""
from portbench import program_spans


def read(rec):
    return program_spans.per_top("frustum.probe", "frustum.solve")
