"""Share of its brute-force roofline that the 1-NN kernel reaches on the
ICP path: ``counts.nn1_s`` of one launch (every pair's inits against its
pseudo cloud), times the launches the trace counts, over their device
time."""
from portbench import counts, trace

KERNELS = ("nn1_kernel",)


def read(rec):
    if rec.profile is None:
        return None
    us, n = trace.kernel_us(rec.profile, KERNELS)
    if n == 0 or us <= 0:
        return None
    bound = counts.nn1_s(*counts.icp_nn1_shape(rec.cfg, rec.traffic)) * n
    return 100.0 * bound / (us / 1e6)
