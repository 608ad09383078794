"""Views projected by the projection kernel over the views binned in the
fit's profiled stretch, in %: how much of ``render_dual``'s preprocess and
table packs goes through the one-launch kernel
(``splatpu_torch/render/project.py``) and not through ``preprocess`` per
view, replayed by autograd.  The program's ``views_projected`` and
``views`` counters (``take_counts``, read once by the fit driver).  A
program that keeps no count of projected views reads nothing."""

from splatbench.readings_fit import counts


def read(reading, part):
    c = counts(reading, part)
    if not c.get("views") or "views_projected" not in c:
        return None
    return 100.0 * c["views_projected"] / c["views"]
