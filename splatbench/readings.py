"""Helpers of the per-layer metric readers (``metrics/<family>.py``).

A reader takes the run's ``reading`` and the part of the metric's name after
its first dot, which names the kind of unit: ``train`` (a stage-2 step).  It returns None where the run has nothing to
read, and the metric is then left out.
"""

from __future__ import annotations

E2E_OF = {"train": "train_step_ms"}


def unit_ms(reading: dict, part: str):
    """The unprofiled ms per step of the run, if it has one of
    this kind."""
    key = E2E_OF.get(part)
    return reading["e2e"].get(key) if key else None


def traced(reading: dict, part: str) -> bool:
    return "trace" in reading and unit_ms(reading, part) is not None and reading["units"] > 0


def host_ms_per_unit(reading: dict, part: str, name: str):
    if not traced(reading, part) or name not in reading["trace"]["host_ms"]:
        return None
    return reading["trace"]["host_ms"][name] / reading["units"]


def roofline(reading: dict, part: str, marker: str, bound_key: str):
    """100 x the frozen bound of one launch over the profiled ms per launch."""
    from splatbench.harness import kernel_ms_per_launch

    if not traced(reading, part):
        return None
    ms = kernel_ms_per_launch(reading["trace"], marker)
    if not ms:
        return None
    return 100.0 * reading["work"][bound_key] / ms
