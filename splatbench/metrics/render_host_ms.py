"""Host ms per step inside the program's ``render`` ranges
(binning's eager launches and the composites' wrappers), profiled."""

from splatbench.readings import host_ms_per_unit


def read(reading, part):
    return host_ms_per_unit(reading, part, "render")
