"""The forward composite K1's share of its roofline: the frozen bound of one
launch at the cell's inputs (``counts.composite_bounds``) over the profiled
ms per K1 launch, in %."""

from splatbench.readings import roofline


def read(reading, part):
    return roofline(reading, part, "composite_fwd_kernel", "fwd_ms")
