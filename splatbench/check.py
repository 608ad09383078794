"""The comparison that decides ``correct`` for a training cell.

The program's first three steps against the reference's, by three numbers:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the first gradient, as the optimizer holds it after one step,
  by the worst leaf: |(program's norm) - (reference's norm)| over the larger
  of the reference leaf's norm and the median leaf's;
- ``change``: the parameters' change after three steps, by the worst leaf,
  measured the same way.  A leaf whose reference gradient stays under a
  thousandth of the median leaf's at every one of the three steps is left
  out: Adam moves it by round-off alone;
- ``change_median``: the same gap of the median leaf, for a cell whose worst
  leaf's gap swings from seed to seed with the round-off of one small leaf
  (``PERF.md`` gives both readings of such a cell).

Each number is held to the cell's limit (``limits/<cell>.json``), set from
the program's readings over a dozen seeds and the control's.
"""

from __future__ import annotations

import statistics

import torch

ROUNDOFF_SHARE = 1e-3


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Per leaf: |program's norm - reference's| over the larger of the
    reference leaf's norm and the median leaf's."""
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values()) if rn else 0.0
    out = {}
    for k in keys:
        den = max(rn[k], med)
        gap = abs(pn[k] - rn[k])
        out[k] = 0.0 if gap == 0.0 else gap / den if den > 0.0 else float("inf")
    return out


def _worst(gaps: dict) -> tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def training_numbers(program: dict, reference: dict) -> dict:
    """``program``: ``losses`` (3), ``grad1`` {leaf}, ``change`` {leaf};
    ``reference``: ``losses``, ``grads`` [3 x {leaf}], ``params`` [4 x {leaf}]."""
    losses = [abs(p - r) / abs(r) if r else abs(p - r)
              for p, r in zip(program["losses"], reference["losses"])]
    grad, grad_leaf = _worst(_gaps(program["grad1"], reference["grads"][0],
                                   list(reference["grads"][0])))
    gmax = {k: max(float(torch.linalg.vector_norm(g[k].double())) for g in reference["grads"])
            for k in reference["grads"][0]}
    med = statistics.median(gmax.values())
    kept = [k for k, v in gmax.items() if v >= ROUNDOFF_SHARE * med]
    ref_change = {k: reference["params"][-1][k] - reference["params"][0][k] for k in kept}
    change_gaps = _gaps(program["change"], ref_change, kept)
    change, change_leaf = _worst(change_gaps)
    return {
        "loss": max(losses) if len(losses) == len(reference["losses"]) else float("inf"),
        "grad": grad,
        "change": change,
        "change_median": statistics.median(change_gaps.values()),
        "_detail": {"losses_program": program["losses"], "losses_reference": reference["losses"],
                    "grad_leaf": grad_leaf, "change_leaf": change_leaf,
                    "change_top": sorted(change_gaps.items(), key=lambda kv: -kv[1])[:3],
                    "left_out": sorted(set(gmax) - set(kept))},
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limits' names."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
