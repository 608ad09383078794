"""Host ms per step inside the program's ``deform_bwd`` range (the backward
from the activated cloud to the network's parameters), profiled."""

from splatbench.readings import host_ms_per_unit


def read(reading, part):
    return host_ms_per_unit(reading, part, "deform_bwd")
