"""Share of its roofline that the kNN kernel reaches in the forward: the
bound of the forward's four launches (``counts.knn_s``) times the
forwards profiled, over the device time of the kernels named below."""
from portbench import counts, trace

KERNELS = ("knn_rows_kernel", "knn_warp_kernel")


def read(rec):
    if rec.profile is None:
        return None
    us, n = trace.kernel_us(rec.profile, KERNELS)
    if n == 0 or us <= 0:
        return None
    B = rec.traffic["batch"]
    bound = sum(counts.knn_s(*c) for c in counts.detector_knn_calls(rec.cfg, B))
    return 100.0 * bound * rec.profile_batches / (us / 1e6)
