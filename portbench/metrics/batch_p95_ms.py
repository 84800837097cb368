"""95th percentile, over every batch of the window, of the host-clock time
from a batch's submission to its answers on the host, in ms."""
import numpy as np


def read(rec):
    return float(np.percentile([1e3 * (te - ts) for ts, te, _ in rec.batches],
                               95))
