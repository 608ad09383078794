"""Faults planted in the program under test, to show that the comparison
catches them (``calibrate.py`` on the card, ``tests/`` on the CPU).  Each is
a context manager that patches one function of the program and restores it.

- ``unchanged``: the optimizer's step leaves the parameters as they were;
- ``half_batch``: the later half of the step's views is left out and the
  mean is taken over the rest;
- ``rows``: the backward composite's answer is altered where it is produced
  (every gradient row scaled by 1.1).
Faults of the exchange between chips do not apply: every cell is on one chip.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "rows")


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def plant(fault: str):
    from splatpu_torch.render import exact
    from splatpu_torch.train import optim, stage2

    if fault == "unchanged":
        with patched(optim.Stage2Adam, "step", lambda self, params, grads: (
                self.update(grads), 0.0)[1]):
            yield
    elif fault == "half_batch":
        orig = stage2.view_losses

        def half(args, camera, w2c, K, images, weights, renderer, binning, batching):
            v = w2c.shape[0]
            h = (v + 1) // 2
            l1, s, o, so, p = orig(args, camera, w2c[:h], K[:h], images[:h],
                                   None if weights is None else weights[:h], renderer,
                                   binning, batching)
            return l1 * (v / h), s * (v / h), o, so, p

        with patched(stage2, "view_losses", half):
            yield
    elif fault == "rows":
        saved = dict(exact.KERNELS)

        def scaled(bwd):
            return lambda *a, **k: bwd(*a, **k) * 1.1

        for key, (fwd, bwd, route) in saved.items():
            exact.KERNELS[key] = (fwd, scaled(bwd), route)
        try:
            yield
        finally:
            exact.KERNELS.clear()
            exact.KERNELS.update(saved)
    else:
        raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")


def no_fault():
    return contextlib.nullcontext()

