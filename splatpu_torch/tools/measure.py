"""Measurement helpers shared by ``chip_smoke.py``, the tools and the GPU
tests: card time per call and the per-row scaled error of gradient rows."""

from __future__ import annotations

SPACER_CYCLES = 100_000_000  # ~50 ms of card clock ahead of each timed run


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Card time per call of ``fn``, CUDA events around ``reps`` calls.  The
    card first sleeps ~50 ms while the host queues the calls, so a kernel
    shorter than its wrapper's host time runs back to back and is timed on
    the card, not at the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPACER_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def row_scaled_err(got, ref) -> float:
    """max over the last dimension's rows of max|got - ref| / max|ref|."""
    d = (got - ref).abs().reshape(-1, got.shape[-1]).amax(0)
    s = ref.abs().reshape(-1, ref.shape[-1]).amax(0)
    return float((d / s.clamp(min=1e-30)).max())
