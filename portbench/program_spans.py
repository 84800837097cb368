"""The program's own spans (``deepi2p_tpu_torch/utils/profiling.py``): the
per-layer metrics that read them.  The spans record only while a
profiler runs, so the table holds the profiled window of a ``--trace 1``
run.  A program without the span table reads nothing."""


def table() -> dict:
    """The program's span table, or {} where it has none."""
    from deepi2p_tpu_torch.utils import profiling
    read = getattr(profiling, "span_table", None)
    return read() if read is not None else {}


def per_top(name: str, top: str, field: str = "device_ms"):
    """``field`` (ms) of the span ``name`` over the calls of the
    top-level span ``top`` (train steps, ICP batches); None where the
    table has no ``top`` or no device time (no card)."""
    t = table()
    if top not in t or name not in t or t[top].device_ms is None:
        return None
    return getattr(t[name], field) / t[top].calls
