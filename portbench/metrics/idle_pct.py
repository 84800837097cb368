"""Share of the batch (or train step) time in which the device runs
nothing, in %: one less the device-busy time per batch over the batch
time.  The two come from two windows of the same run: the busy time is
the union of the device operations' intervals in the profiled window,
over its batches; the batch time is the host clock's over the timed
window, which runs without the profiler.  The profiled window's own idle
share (``device.busy_s`` over ``device.window_s``) is larger: the
profiler's host cost lengthens it.  One reader for every cell:
``idle_pct.<kind>`` names it per end-to-end metric it moves."""
from portbench import trace


def read(rec):
    if rec.profile is None or rec.profile["window"] is None \
            or not rec.profile["device"]:
        return None
    busy = trace.busy_s(rec.profile) / rec.profile_batches
    return 100.0 * (1.0 - busy / (rec.window_s / len(rec.batches)))
