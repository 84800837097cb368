"""The whole ICP batch's share of the card's float32 peak, in %: the
brute-force operations of the 1-NN launches the trace counts per profiled
batch (``counts.nn1_ops``; the Kabsch steps and transforms add under a
thousandth), over the batch time of the timed window and 67 TFLOP/s.  It
bounds a claim on the whole batch when a later kernel leaves the 1-NN's
roofline silent."""
from portbench import counts, trace

KERNELS = ("nn1_kernel",)


def read(rec):
    if rec.profile is None:
        return None
    _, n = trace.kernel_us(rec.profile, KERNELS)
    if n == 0:
        return None
    S, N, _, M = counts.icp_nn1_shape(rec.cfg, rec.traffic)
    ops = counts.nn1_ops(S, N, M) * n / rec.profile_batches
    step_s = rec.window_s / len(rec.batches)
    return 100.0 * ops / (step_s * counts.PEAK_F32_OPS)
