"""Exact self-kNN by chunked brute force (port of
``splatpu/neighbors/knn.py::knn_bruteforce``).

Squared distances |a|^2 + |b|^2 - 2 a.b over chunks of query rows against
all points, in float32 with TF32 off (a TF32 product keeps ~3 digits and
reorders near neighbours), each point excluded from its own row by index
(so duplicates still find their twin), then the k smallest by a stable
sort, so that among equal distances the lower index comes first, as JAX's
``lax.top_k`` orders them (``torch.topk`` makes no such promise, and exact
ties are common: a densification clone starts as a copy of its source,
and grid-like scenes are full of equidistant points).  The chunk is
sized so that one (chunk, N) distance block stays near 256 MB.  The JAX
package routes inputs above 200,000 points to a native KD-tree; that route
is not ported yet, and the brute force takes every size.
"""

from __future__ import annotations

import torch

from splatpu_torch.dynamics.network import no_tf32

DIST_MATRIX_BUDGET_BYTES = 256 << 20


def auto_chunk(n: int) -> int:
    rows = DIST_MATRIX_BUDGET_BYTES // max(4 * n, 1)
    return int(max(8, min(1024, (rows // 8) * 8)))


def knn_bruteforce(points: torch.Tensor, k: int, chunk: int | None = None):
    """(N, 3) points -> (indices (N, k) int32, squared distances (N, k)),
    neighbours sorted by ascending distance.  With k > N - 1 the N - 1 real
    neighbours are padded with index 0 and distance inf."""
    n = points.shape[0]
    if chunk is None:
        chunk = auto_chunk(n)
    if k > n - 1:
        idx, d2 = knn_bruteforce(points, max(n - 1, 1), chunk)
        pad = k - idx.shape[1]
        idx = torch.cat([idx, torch.zeros((n, pad), dtype=idx.dtype, device=idx.device)], 1)
        d2 = torch.cat([d2, torch.full((n, pad), float("inf"), device=d2.device)], 1)
        return idx, d2
    pts = points.float()
    sq_norm = (pts * pts).sum(-1)
    all_ids = torch.arange(n, device=pts.device)
    idx_out, d2_out = [], []
    with no_tf32():
        for r0 in range(0, n, chunk):
            q = pts[r0 : r0 + chunk]
            cross = q @ pts.T
            d2 = (q * q).sum(-1)[:, None] + sq_norm[None, :] - 2.0 * cross
            rows = all_ids[r0 : r0 + q.shape[0]]
            d2[torch.arange(q.shape[0], device=pts.device), rows] = float("inf")
            d2_sorted, idx = torch.sort(d2, dim=1, stable=True)
            idx_out.append(idx[:, :k].to(torch.int32))
            d2_out.append(torch.clamp(d2_sorted[:, :k], min=0.0))
    return torch.cat(idx_out), torch.cat(d2_out)
