"""The whole train step's share of the card's peak: three times the
detector forward's model FLOPs per step (the forward, and the backward
to the activations and to the weights), over the step time of the timed
window and the bf16 dense peak, in %."""
from portbench import counts


def read(rec):
    step_s = rec.window_s / len(rec.batches)
    flops = 3.0 * counts.detector_forward_flops(rec.cfg, rec.traffic["batch"])
    return 100.0 * flops / (step_s * counts.PEAK_BF16_FLOPS)
