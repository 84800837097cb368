"""Share of its roofline that the 2-D LM kernel reaches: the bound of each
profiled launch from the frozen label table (``counts.lm_s`` on the
launch's own labels), over the device time of the kernels named below."""
from portbench import counts, trace

KERNELS = ("lm_kernel<4",)


def read(rec):
    if rec.profile is None or not rec.extra.get("lm_launches"):
        return None
    us, n = trace.kernel_us(rec.profile, KERNELS)
    if n == 0 or us <= 0:
        return None
    bound = sum(counts.lm_s(*launch) for launch in rec.extra["lm_launches"])
    return 100.0 * bound / (us / 1e6)
