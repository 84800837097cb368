"""Device-busy time per train step, in ms: the union of the device
operations' intervals in the profiled window, over its steps."""
from portbench import trace


def read(rec):
    if rec.profile is None or rec.profile["window"] is None \
            or not rec.profile["device"]:
        return None
    return 1e3 * trace.busy_s(rec.profile) / rec.profile_batches
