"""Views projected by the projection kernel over the views binned, over the
profiled stretch, in %: how much of the render's preprocess goes through
the one-launch kernel (``splatpu_torch/render/project.py``) and not through
``preprocess`` per view.  The counts are the program's
(``splatpu_torch.obs.profiling.take_counts``), which empties its store: they
are taken once per run and kept in the reading, as ``lane_fill`` keeps them.
A program that keeps no count of projected views reads nothing."""

from splatbench.readings import traced


def read(reading, part):
    if not traced(reading, part):
        return None
    if "binning_counts" not in reading:
        from splatpu_torch.obs import profiling

        take = getattr(profiling, "take_counts", None)
        reading["binning_counts"] = take() if take is not None else {}
    c = reading["binning_counts"]
    if not c.get("views") or "views_projected" not in c:
        return None
    return 100.0 * c["views_projected"] / c["views"]
