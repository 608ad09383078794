"""Kernels launched per stage-2 step in the device trace (a count)."""

from splatbench.readings import traced


def read(reading, part):
    if part != "train" or not traced(reading, part):
        return None
    return reading["trace"]["launches"] / reading["units"]
