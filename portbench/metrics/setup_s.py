"""Process start to the first timed batch: imports, CUDA, the kernel
library (built on a checkout's first run), inputs, weights and warm-up."""


def read(rec):
    return rec.setup_s
