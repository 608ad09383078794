"""Host ms per step inside the program's ``preprocess`` ranges (``render/exact.py``,
within ``render``), profiled."""

from splatbench.readings import host_ms_per_unit


def read(reading, part):
    return host_ms_per_unit(reading, part, "preprocess")
