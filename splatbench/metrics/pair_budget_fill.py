"""Exact binning's pairs kept over its budget slots, over the profiled
stretch, in %: how much of the work done for every budget slot (K2's rows,
the routing, the pad) is work.  The counts are the program's
(``splatpu_torch.obs.profiling.take_counts``), which empties its store: they
are taken once per run and kept in the reading for ``lane_fill`` too."""

from splatbench.readings import traced


def read(reading, part):
    if not traced(reading, part):
        return None
    if "binning_counts" not in reading:
        from splatpu_torch.obs import profiling

        take = getattr(profiling, "take_counts", None)
        reading["binning_counts"] = take() if take is not None else {}
    c = reading["binning_counts"]
    return 100.0 * c["pairs_kept"] / c["budget_slots"] if c.get("budget_slots") else None
