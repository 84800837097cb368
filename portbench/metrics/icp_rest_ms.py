"""ICP batch time outside the 1-NN kernel, in ms: the host-clock batch
time of the timed window, less the 1-NN kernels' device time per profiled
batch (the Kabsch steps, transforms, gathers and small launches)."""
from portbench import trace

KERNELS = ("nn1_kernel",)


def read(rec):
    if rec.profile is None:
        return None
    us, n = trace.kernel_us(rec.profile, KERNELS)
    if n == 0:
        return None
    batch_ms = 1e3 * rec.window_s / len(rec.batches)
    return batch_ms - us / 1e3 / rec.profile_batches
