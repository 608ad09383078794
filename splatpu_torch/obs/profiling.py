"""Timing and tracing helpers (port of ``splatpu/obs/profiling.py``).

- ``force_completion``: wait for the card's queued work;
- ``time_fn``: ms per call, a host clock around each batch of calls and
  the wait for its completion, in batches whose spread is reported;
- ``trace``: ``torch.profiler`` over a block, its Chrome trace written to a
  directory;
- ``debug_nan_mode``: autograd anomaly detection over a block;
- ``launch_counts`` / ``zero_counts``: every kernel's launch counter.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from pathlib import Path
from typing import Callable

import torch

# Every kernel's launch counter, by kernel: (module, attribute).
COUNTERS = {
    "composite_fwd": ("splatpu_torch.render.composite", "LAUNCHES"),
    "composite_bwd": ("splatpu_torch.render.composite", "BWD_LAUNCHES"),
    "route_pairs": ("splatpu_torch.render.route", "LAUNCHES"),
    "composite_manual_fwd": ("splatpu_torch.render.composite", "MANUAL_LAUNCHES"),
    "composite_manual_bwd": ("splatpu_torch.render.composite", "MANUAL_BWD_LAUNCHES"),
    "padded_fwd": ("splatpu_torch.render.padded", "LAUNCHES"),
    "padded_bwd": ("splatpu_torch.render.padded", "BWD_LAUNCHES"),
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


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` (CPU and, with a card, CUDA activity) over the
    block; the Chrome trace goes to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@contextlib.contextmanager
def debug_nan_mode():
    with torch.autograd.detect_anomaly():
        yield
