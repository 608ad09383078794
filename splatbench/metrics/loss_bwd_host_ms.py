"""Host ms per step inside the program's ``loss_bwd`` range (the backward
from the loss to the rendered images: L1's and SSIM's), profiled."""

from splatbench.readings import host_ms_per_unit


def read(reading, part):
    return host_ms_per_unit(reading, part, "loss_bwd")
