"""Timing and tracing helpers (port of ``splatpu/obs/profiling.py``).

- ``force_completion``: wait for the card's queued work;
- ``time_fn``: ms per call, a host clock around each batch of calls and
  the wait for its completion, in batches whose spread is reported;
- ``launch_counts`` / ``zero_counts``: every kernel's launch counter;
- ``BackwardPhases``: a stage-2 step's backward split into ``loss_bwd``,
  ``render_bwd`` and ``deform_bwd`` ranges, while a profiler records;
- ``count_binning`` / ``count_projection`` / ``take_counts``: exact
  binning's pairs kept, lane slots sorted and budget slots, and the views
  the projection kernel projected, counted while a profiler records.

The program's spans are ``torch.profiler`` ranges (``record_function``),
so they share the clock of the profiler's device trace.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable

import torch
from torch.profiler import record_function

# Every kernel's launch counter, by kernel: (module, attribute).
COUNTERS = {
    "composite_fwd": ("splatpu_torch.render.composite", "LAUNCHES"),
    "composite_bwd": ("splatpu_torch.render.composite", "BWD_LAUNCHES"),
    "route_pairs": ("splatpu_torch.render.route", "LAUNCHES"),
    "composite_manual_fwd": ("splatpu_torch.render.composite", "MANUAL_LAUNCHES"),
    "composite_manual_bwd": ("splatpu_torch.render.composite", "MANUAL_BWD_LAUNCHES"),
    "padded_fwd": ("splatpu_torch.render.padded", "LAUNCHES"),
    "padded_bwd": ("splatpu_torch.render.padded", "BWD_LAUNCHES"),
    "project_fwd": ("splatpu_torch.render.project", "LAUNCHES"),
    "project_bwd": ("splatpu_torch.render.project", "BWD_LAUNCHES"),
}


def launch_counts() -> dict:
    return {k: getattr(importlib.import_module(m), a) for k, (m, a) in COUNTERS.items()}


def zero_counts() -> None:
    for m, a in COUNTERS.values():
        setattr(importlib.import_module(m), a, 0)


def force_completion(device=None) -> None:
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10, args_fn=None,
            batches: int = 2, device="cuda") -> dict:
    """{'mean_ms', 'spread_ms', 'iters', 'timer'} of ``fn(*args)``, timed as
    the JAX package's ``time_fn`` is: ``warmup + 1`` warm-up calls, then the
    iterations in ``batches`` batches, each read on the host clock from a
    synchronised device to the completion of its last call; ``spread_ms`` is
    the largest minus the smallest batch mean.

    ``args_fn(i) -> tuple`` gives call ``i`` its own inputs (warm-up calls
    ``-(warmup + 1) .. -1``, timed calls ``0 .. iters - 1``); every input is
    built before the first call, so that building them is not timed."""
    get = args_fn if args_fn is not None else (lambda i: args)
    inputs = [get(i) for i in range(-(warmup + 1), iters)]
    for a in inputs[: warmup + 1]:
        fn(*a)
    timed = iter(inputs[warmup + 1:])
    batches = max(1, min(batches, iters))
    per = [iters // batches + (1 if i < iters % batches else 0) for i in range(batches)]
    batch_ms = []
    for count in per:
        force_completion(device)
        t0 = time.perf_counter()
        for _ in range(count):
            fn(*next(timed))
        force_completion(device)
        batch_ms.append(1e3 * (time.perf_counter() - t0) / count)
    return {
        "mean_ms": sum(m * c for m, c in zip(batch_ms, per)) / iters,
        "spread_ms": max(batch_ms) - min(batch_ms),
        "iters": iters,
        "timer": "host_clock",
    }


class BackwardPhases:
    """One step's backward as three ``record_function`` ranges, opened and
    closed by autograd hooks on the thread that runs the backward
    (autograd's device thread on a card):

    - ``loss_bwd``: from the differentiated loss's node (``loss``) until the
      gradients of every rendered image have arrived (``images``): the L1's
      and SSIM's backward;
    - ``render_bwd``: from there until the gradients of the activated
      cloud's tensors that require grad have arrived: the composite's
      backward, its routing, the table's and preprocess's backward, and
      whatever else reaches those tensors first (stage 2's rigidity);
    - ``deform_bwd``: from there until every parameter's gradient has
      arrived (``params``): the deformation network's backward.

    ``begin`` makes the step's phases only while a profiler records, and
    sets them as ``current``, which ``stage2.view_losses`` reads to mark the
    images; ``end`` closes what is still open and clears ``current``.  With
    no profiler no hook is registered.  Each hook removes itself when it
    fires: a hook on a leaf tensor would otherwise fire in later steps."""

    current: "BackwardPhases | None" = None

    def __init__(self):
        self._open = None

    @classmethod
    def begin(cls) -> "BackwardPhases | None":
        cls.current = cls() if torch.autograd._profiler_enabled() else None
        return cls.current

    def _enter(self, name: str | None) -> None:
        """Close the open range, then open ``name`` (if any)."""
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None:
            self._open = record_function(name)
            self._open.__enter__()

    def _after(self, tensors, name: str | None) -> None:
        """Enter ``name`` once the gradients of ``tensors`` have arrived."""
        tensors = [t for t in tensors if t is not None and t.requires_grad]
        if not tensors:
            return
        handle = None

        def arrived(grads):
            handle.remove()
            self._enter(name)

        handle = torch.autograd.graph.register_multi_grad_hook(tensors, arrived, mode="all")

    def loss(self, loss: torch.Tensor) -> None:
        """Open ``loss_bwd`` when the backward reaches ``loss``."""
        if loss.grad_fn is not None:
            loss.grad_fn.register_prehook(lambda grad_outputs: self._enter("loss_bwd"))

    def images(self, images, cloud) -> None:
        """The rendered ``images`` and the activated ``cloud`` tensors they
        were rendered from."""
        self._after(images, "render_bwd")
        self._after(cloud, "deform_bwd")

    def params(self, params) -> None:
        self._after(params, None)

    def end(self) -> None:
        self._enter(None)
        BackwardPhases.current = None


# Exact binning's counters, one entry per view binned while a profiler
# records: (pairs before clipping, a device scalar as binning left it; lane
# slots sorted; budget slots).  Read and cleared by ``take_counts``.
_BINNING: list[tuple[torch.Tensor, int, int]] = []
# The views projected by the projection kernel (``render/project.py``) while
# a profiler records.  Read and cleared by ``take_counts``.
_PROJECTED = [0]


def count_binning(total_pairs: torch.Tensor, lane_slots: int, budget_slots: int) -> None:
    """Keep one view's binning counts; launches nothing and reads nothing."""
    _BINNING.append((total_pairs, lane_slots, budget_slots))


def count_projection(views: int) -> None:
    """Count the views of one launch of the projection kernel."""
    _PROJECTED[0] += views


def take_counts() -> dict:
    """The binning counts kept since the last call, summed over the views:
    ``views``, ``views_projected`` (by the projection kernel),
    ``pairs_kept`` (each view's pairs clipped to its budget),
    ``lane_slots`` and ``budget_slots``; ``{}`` where no view was binned.
    One synchronise; the store is emptied."""
    projected, _PROJECTED[0] = _PROJECTED[0], 0
    if not _BINNING:
        return {}
    kept = list(_BINNING)
    _BINNING.clear()
    dev = kept[0][0].device
    pairs = torch.stack([t.reshape(()).to(dev, torch.int64) for t, _, _ in kept])
    budgets = torch.tensor([b for _, _, b in kept], dtype=torch.int64, device=dev)
    return {
        "views": len(kept),
        "views_projected": projected,
        "pairs_kept": int(torch.minimum(pairs, budgets).sum()),
        "lane_slots": sum(n for _, n, _ in kept),
        "budget_slots": sum(b for _, _, b in kept),
    }
