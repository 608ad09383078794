"""The per-row scaled error of gradient rows, shared by ``chip_smoke.py``
and the tests."""

from __future__ import annotations


def row_scaled_err(got, ref) -> float:
    """max over the last dimension's rows of max|got - ref| / max|ref|."""
    d = (got - ref).abs().reshape(-1, got.shape[-1]).amax(0)
    s = ref.abs().reshape(-1, ref.shape[-1]).amax(0)
    return float((d / s.clamp(min=1e-30)).max())
