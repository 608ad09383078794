"""Gradient routing: per-pair gradient rows -> per-Gaussian gradients (port of
``splatpu/render/exact.py:361-380`` ``pos_of_slot_of`` and ``:1316-1394``
``_cumsum_pairs_pallas`` / ``_route_to_table``).

Every Gaussian g of a view owns the contiguous emission slots
``[offsets[g], offsets[g] + counts[g])``; the binning sort moved each kept
slot to a sorted pair position.  ``pos_of_slot_of`` inverts that map (P for
a dropped slot) for the exact stream; the padded stream carries its own
(``PairStream.q_of_slot``, padded to P by ``padded.routing_slots``).  The
routing sums each Gaussian's pair rows over its slots, 7 + C rows for C of
1..9 (K4's and K5's widest):

- ``route_pairs_cuda`` launches ``csrc/route_pairs.cu``, which replaces the
  TPU's carried cumsum kernel: one warp per (view, Gaussian) sums the rows
  directly, at every budget (the TPU kernel ran only at P >= 2^19);
- ``route_pairs_plain`` is ``_route_to_table`` in torch: gather into slot
  order, cumsum along the slots (in float64), boundary differences.

Shapes: rows (V, P, R), pos_of_slot (V, P) int32, offsets and counts
(V, N) int32 -> (V, N, R) float32.
"""

from __future__ import annotations

import ctypes

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


def _check(rows, pos_of_slot, offsets, counts):
    if rows.dim() != 3 or pos_of_slot.shape != rows.shape[:2]:
        raise ValueError("expected rows (V, P, R) and pos_of_slot (V, P)")
    if offsets.dim() != 2 or offsets.shape[0] != rows.shape[0] or counts.shape != offsets.shape:
        raise ValueError("expected offsets and counts (V, N) over the rows' views")
    for name, x, dt in (
        ("rows", rows, torch.float32), ("pos_of_slot", pos_of_slot, torch.int32),
        ("offsets", offsets, torch.int32), ("counts", counts, torch.int32),
    ):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")


def route_pairs_cuda(rows, pos_of_slot, offsets, counts) -> torch.Tensor:
    """Launch the routing kernel; every tensor must be a contiguous CUDA tensor."""
    global LAUNCHES
    tensors = (rows, pos_of_slot, offsets, counts)
    _build.require_cuda("route_pairs_cuda", tensors)
    _check(*tensors)
    v, p, r = rows.shape
    if not 8 <= r <= 16:
        raise ValueError(f"the routing kernel takes 8..16 rows (7 + 1..9 channels), got {r}")
    n = offsets.shape[1]
    out = torch.empty((v, n, r), dtype=torch.float32, device=rows.device)
    lib = _build.load_library()
    fn = lib.splatpu_route_pairs
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = fn(*(x.data_ptr() for x in tensors), out.data_ptr(), v, n, p, r, stream)
    _build.check_status(lib, code, "route_pairs launch")
    LAUNCHES += 1
    return out


def route_pairs_plain(rows, pos_of_slot, offsets, counts) -> torch.Tensor:
    """``_route_to_table`` in torch: gather the rows into emission-slot
    order, cumsum along the slots, difference at each Gaussian's last slot.
    The cumsum runs in float64, so its rounding (~eps x the running sum)
    stays far below the float32 sums it is compared with."""
    _check(rows, pos_of_slot, offsets, counts)
    v, p, r = rows.shape
    valid = pos_of_slot < p
    idx = torch.clamp(pos_of_slot.long(), max=p - 1)[..., None].expand(v, p, r)
    slotg = torch.where(valid[..., None], torch.gather(rows, 1, idx), torch.zeros_like(rows))
    csum = torch.cumsum(slotg.double(), dim=1)
    ends = offsets.long() + counts.long()
    at = torch.clamp(ends - 1, 0, p - 1)[..., None].expand(v, ends.shape[1], r)
    b = torch.where((ends > 0)[..., None], torch.gather(csum, 1, at), torch.zeros_like(at, dtype=csum.dtype))
    out = b - torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], dim=1)
    return out.float()
