"""The card's idle share of a step: 1 - (device busy ms per step in the
profiled stretch, kernels and copies merged) / (unprofiled ms per step), in %."""

from splatbench.readings import traced, unit_ms


def read(reading, part):
    if not traced(reading, part):
        return None
    busy_ms = 1e3 * reading["trace"]["busy_s"] / reading["units"]
    return 100.0 * (1.0 - busy_ms / unit_ms(reading, part))
