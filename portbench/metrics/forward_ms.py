"""Mean device time of the detector's forward per batch (CUDA events
around the benchmark's call into the model, in the timed window of a
traced run)."""
import statistics


def read(rec):
    ms = rec.span_ms.get("forward")
    return statistics.fmean(ms) if ms else None
