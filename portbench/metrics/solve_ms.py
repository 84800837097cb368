"""Mean device time of ``solve_frustum_batch`` per batch (CUDA events
around the benchmark's call, in the timed window of a traced run)."""
import statistics


def read(rec):
    ms = rec.span_ms.get("solve")
    return statistics.fmean(ms) if ms else None
