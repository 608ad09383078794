"""The whole step's share of the card's FP32 peak: the frozen FLOPs of one
step (composites, network, SSIM; ``counts``) over the unprofiled ms per step
times 67 TFLOP/s, in %."""

from splatbench.counts import PEAK_FP32_FLOPS
from splatbench.readings import traced, unit_ms


def read(reading, part):
    if not traced(reading, part):
        return None
    return 100.0 * reading["work"]["step_flops"] / (unit_ms(reading, part) / 1e3 * PEAK_FP32_FLOPS)
