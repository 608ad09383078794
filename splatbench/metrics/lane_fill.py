"""Exact binning's pairs kept over the lane slots it sorted, over the
profiled stretch, in %: how much of the key sort and the lane cumsum is
work.  The counts are the program's (``splatpu_torch.obs.profiling
.take_counts``), which empties its store: they are taken once per run and
kept in the reading for ``pair_budget_fill`` too."""

from splatbench.readings import traced


def read(reading, part):
    if not traced(reading, part):
        return None
    if "binning_counts" not in reading:
        from splatpu_torch.obs import profiling

        take = getattr(profiling, "take_counts", None)
        reading["binning_counts"] = take() if take is not None else {}
    c = reading["binning_counts"]
    return 100.0 * c["pairs_kept"] / c["lane_slots"] if c.get("lane_slots") else None
