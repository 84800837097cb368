"""The whole batch's share of the card's peak: the detector forward's
model FLOPs per batch (``counts.detector_forward_flops``), over the batch
time of the timed window and the bf16 dense peak, in %."""
from portbench import counts


def read(rec):
    step_s = rec.window_s / len(rec.batches)
    flops = counts.detector_forward_flops(rec.cfg, rec.traffic["batch"])
    return 100.0 * flops / (step_s * counts.PEAK_BF16_FLOPS)
