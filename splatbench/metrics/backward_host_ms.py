"""Host ms per step inside the program's ``backward`` range
(autograd's backward), profiled."""

from splatbench.readings import host_ms_per_unit


def read(reading, part):
    return host_ms_per_unit(reading, part, "backward")
