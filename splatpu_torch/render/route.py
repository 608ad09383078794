"""Gradient routing: per-pair gradient rows -> per-Gaussian gradients (port of
``splatpu/render/exact.py:361-380`` ``pos_of_slot_of`` and ``:1316-1394``
``_cumsum_pairs_pallas`` / ``_route_to_table``, and of the padded
stream's routing in ``splatpu/render/pallas_composite.py:507-520``).

Every Gaussian g of a view owns the contiguous emission slots
``[offsets[g], offsets[g] + counts[g])``; the binning sort moved each slot
to a sorted pair position, which a slot map gives.  The routing sums each
Gaussian's pair rows over its slots, 7 + C rows for C of 1..9 (K4's and
K5's widest), in one of two slot modes:

- exact (K2, K4; ``padded=False``): the slot map is ``pos_of_slot_of``'s
  (V, P), over the rows' P positions, P for a slot the sort dropped; slots
  past P and dropped slots add nothing;
- padded (K5; ``padded=True``): the slot map is the padded stream's
  ``q_of_slot`` (V, S), S = ``max_pairs``; slot s reads position
  ``q_of_slot[min(s, S - 1)]``, so on an overflowed render every slot past
  the budget adds the last slot's row once, as the JAX package does.

- ``route_pairs_cuda`` launches ``csrc/route_pairs.cu``, which replaces the
  TPU's carried cumsum kernel: one thread per (view, Gaussian, row) sums
  the rows directly, at every budget (the TPU kernel ran only at P >= 2^19);
- ``route_pairs_plain`` is ``_route_to_table`` in torch: gather into slot
  order, cumsum along the slots (in float64), boundary differences.

Shapes: rows (V, P, R), slot map (V, P) (exact) or (V, S) (padded) int32,
offsets and counts (V, N) int32 -> (V, N, R) float32.
"""

from __future__ import annotations

import torch

from splatpu_torch import _build

LAUNCHES = 0  # kernel launches made by route_pairs_cuda


def pos_of_slot_of(offsets: torch.Tensor, gid: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """(V, P) emission slot -> sorted position, P for dropped slots.

    Kept slots are unique, so this is a scatter of positions to their slots
    (the JAX package sorts (slot, position) pairs, which a TPU does faster
    than a scatter; the integers are the same)."""
    v, p = gid.shape
    dev = gid.device
    off_of_p = torch.gather(offsets, 1, gid.long())
    slot = off_of_p.long() + lane.long()
    rows = torch.arange(v, device=dev)[:, None]
    # Dropped pairs all write to one spare element past the end, which is
    # cut off: no boolean indexing, so no wait for the device.
    flat = torch.where(lane >= 0, rows * p + slot, torch.full_like(slot, v * p))
    pos = torch.arange(p, dtype=torch.int32, device=dev).expand(v, p)
    out = torch.full((v * p + 1,), p, dtype=torch.int32, device=dev)
    out.scatter_(0, flat.reshape(-1), pos.reshape(-1))
    return out[:-1].reshape(v, p)


def _check(rows, slot_map, offsets, counts, padded):
    if rows.dim() != 3 or slot_map.dim() != 2 or slot_map.shape[0] != rows.shape[0]:
        raise ValueError("expected rows (V, P, R) and a slot map (V, S)")
    if not padded and slot_map.shape[1] != rows.shape[1]:
        raise ValueError("the exact stream's slot map must be (V, P), as the rows")
    if offsets.dim() != 2 or offsets.shape[0] != rows.shape[0] or counts.shape != offsets.shape:
        raise ValueError("expected offsets and counts (V, N) over the rows' views")
    for name, x, dt in (
        ("rows", rows, torch.float32), ("slot_map", slot_map, torch.int32),
        ("offsets", offsets, torch.int32), ("counts", counts, torch.int32),
    ):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")


def route_pairs_cuda(rows, slot_map, offsets, counts, padded: bool = False) -> torch.Tensor:
    """Launch the routing kernel; every tensor must be a contiguous CUDA tensor."""
    global LAUNCHES
    tensors = (rows, slot_map, offsets, counts)
    _build.require_cuda("route_pairs_cuda", tensors)
    _check(*tensors, padded)
    v, p, r = rows.shape
    if not 8 <= r <= 16:
        raise ValueError(f"the routing kernel takes 8..16 rows (7 + 1..9 channels), got {r}")
    n = offsets.shape[1]
    out = torch.empty((v, n, r), dtype=torch.float32, device=rows.device)
    lib = _build.load_library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = lib.splatpu_route_pairs(*(x.data_ptr() for x in tensors), out.data_ptr(), v, n, p,
                                       slot_map.shape[1], r, int(padded), stream)
    _build.check_status(lib, code, "route_pairs launch")
    LAUNCHES += 1
    return out


def route_pairs_plain(rows, slot_map, offsets, counts, padded: bool = False) -> torch.Tensor:
    """``_route_to_table`` in torch: gather the rows into emission-slot
    order, cumsum along the slots, difference at each Gaussian's ends.  The
    cumsum runs in float64, so its rounding (~eps x the running sum) stays
    far below the float32 sums it is compared with.

    Exact mode differences consecutive Gaussians' last slots, as the JAX
    package does (each range starts where the previous one ends).  Padded
    mode takes no such order for granted: a range [lo, hi) (lo >= 0) sums
    its slots below S as a difference of the cumsum, and clips those at or
    past S to slot S - 1, each adding that slot's row once, as JAX's clipped
    gather does."""
    _check(rows, slot_map, offsets, counts, padded)
    v, p, r = rows.shape
    if padded:
        s = slot_map.shape[1]
        idx = torch.clamp(slot_map.long(), 0, p - 1)[..., None].expand(v, s, r)
        slotg = torch.gather(rows, 1, idx).double()
        csum = torch.cat([torch.zeros_like(slotg[:, :1]), torch.cumsum(slotg, dim=1)], dim=1)
        lo = offsets.long()
        hi = lo + counts.long()

        def csum_at(x):
            return torch.gather(csum, 1, x.clamp(max=s)[..., None].expand(v, x.shape[1], r))

        beyond = (hi - lo.clamp(min=s)).clamp(min=0)
        out = csum_at(hi) - csum_at(lo) + beyond[..., None] * slotg[:, -1:]
        return out.float()
    valid = slot_map < p
    idx = torch.clamp(slot_map.long(), max=p - 1)[..., None].expand(v, p, r)
    slotg = torch.where(valid[..., None], torch.gather(rows, 1, idx), torch.zeros_like(rows))
    csum = torch.cumsum(slotg.double(), dim=1)
    ends = offsets.long() + counts.long()
    at = torch.clamp(ends - 1, 0, p - 1)[..., None].expand(v, ends.shape[1], r)
    b = torch.where((ends > 0)[..., None], torch.gather(csum, 1, at), torch.zeros_like(at, dtype=csum.dtype))
    out = b - torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], dim=1)
    return out.float()
