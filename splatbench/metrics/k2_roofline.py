"""The backward composite K2's share of its roofline: the frozen bound of one
launch (rows of the pairs emitted) over the profiled ms per K2 launch, in %."""

from splatbench.readings import roofline


def read(reading, part):
    return roofline(reading, part, "composite_bwd_kernel", "bwd_ms")
