"""Host ms per step inside the program's ``render_bwd`` range (the backward
from the rendered images to the activated cloud: the composite's, the
routing's, preprocess's), profiled."""

from splatbench.readings import host_ms_per_unit


def read(reading, part):
    return host_ms_per_unit(reading, part, "render_bwd")
