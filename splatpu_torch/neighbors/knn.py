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
sized so that one (chunk, N) distance block stays near 256 MB.

``knn`` routes inputs above ``NATIVE_THRESHOLD`` points to the native C++
KD-tree (``neighbors/native.py``) where it builds, as the JAX package does
with every concrete input: the points go to the host, the tree answers
there, and the result comes back to the input's device.  Both methods are
exact; below the threshold, or without the library, the brute force
answers.
"""

from __future__ import annotations

import torch

from splatpu_torch.dynamics.network import no_tf32

DIST_MATRIX_BUDGET_BYTES = 256 << 20
NATIVE_THRESHOLD = 200_000


def auto_chunk(n: int) -> int:
    rows = DIST_MATRIX_BUDGET_BYTES // max(4 * n, 1)
    return int(max(8, min(1024, (rows // 8) * 8)))


def knn(points: torch.Tensor, k: int, chunk: int | None = None):
    """Exact self-kNN over (N, 3) points, each point excluded: (indices (N,
    k) int32, squared distances (N, k)), ascending; above
    ``NATIVE_THRESHOLD`` points through the native KD-tree where it builds
    (with k > N - 1 the real neighbours padded with index 0 and distance
    inf, as the brute force pads), else by ``knn_bruteforce``."""
    from splatpu_torch.neighbors import native

    n = points.shape[0]
    if n > NATIVE_THRESHOLD and native.available():
        idx, d2 = native.knn_native(points.detach().cpu().float().numpy(), k=min(k, n - 1))
        idx = torch.from_numpy(idx).to(points.device)
        d2 = torch.from_numpy(d2).to(points.device)
        if k > n - 1:
            pad = k - idx.shape[1]
            idx = torch.cat([idx, torch.zeros((n, pad), dtype=idx.dtype, device=idx.device)], 1)
            d2 = torch.cat([d2, torch.full((n, pad), float("inf"), device=d2.device)], 1)
        return idx, d2
    return knn_bruteforce(points, k, chunk)


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
