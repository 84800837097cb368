"""Device time of the frustum solve's refine launch per solve, in ms: the
CUDA events of the program's ``frustum.refine`` span (the LM kernel on
the probe's survivors at the solver's point stride) in the profiled
window, over its ``frustum.solve`` spans.  None where the program has no
such spans."""
from portbench import program_spans


def read(rec):
    return program_spans.per_top("frustum.refine", "frustum.solve")
