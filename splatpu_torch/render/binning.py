"""Binning budgets, tile-grid helpers and the padded pair stream (port of
``splatpu/render/binning.py:44-147, 198-395``).

``BinningConfig`` carries the fields the port reads.  ``kernel`` picks the
exact path's composite: ``"grid"`` (the default; the port's K1/K2, at most
5 colour channels and 2^24 pairs, as the JAX grid kernel) or ``"manual"``
(K4: up to 9 channels and any budget).  The JAX config's other TPU knobs
(``scan``, ``subchunks``) have no counterpart: the Hopper composites walk
each tile's pairs serially.  ``exact_tie_order`` is the JAX package's: True
breaks (tile, depth) sort ties by gaussian id (the reference's order),
False keeps tied pairs in emission order (class A before class B).
``chunk_pairs`` is the unit budgets are rounded to and, in the padded pair
stream, the alignment of every tile's segment.

``build_pair_stream`` is the first-generation binning that the padded
composite (``render/padded.py``, K5) and ``impl="stream"``
(``render/stream.py``) consume: every Gaussian emits ``min(area,
max_span)`` slots (no two-class emission, no tile cull), one stable sort
of u32 (tile | depth) keys, and each tile's segment re-laid at a chunk
boundary.  Every integer is the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from splatpu_torch.core.projection import Splats2D, preprocess, tile_rect
from splatpu_torch.core.types import Camera, RenderArgs

DEFAULT_TILE = 32
KERNEL_CHOICES = ("grid", "manual")
SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BinningConfig:
    tile: int = 16              # pixels per tile side
    max_span: int = 32          # max tiles one Gaussian may cover
    span_small: int = 16        # lanes every Gaussian emits; wider ones go
                                # through the compacted big class
    big_capacity: int | None = None  # big-class rows; None = heuristic
    max_pairs: int = 2**20      # total pair budget
    chunk_pairs: int = 128      # budget rounding unit; padded segment alignment
    kernel: str = "grid"        # exact-path composite: "grid" or "manual"
    cull_tiles: bool = True     # drop pairs whose alpha bound is < 1/255
    exact_tie_order: bool = True  # (tile, depth) ties by gaussian id; False:
                                  # a stable sort on the key alone

    def padded_capacity(self, num_tiles: int) -> int:
        """Worst-case aligned stream length: every non-empty tile wastes at
        most chunk_pairs - 1 slots."""
        return self.max_pairs + self.chunk_pairs * num_tiles

    def resolved_big_capacity(self, n: int) -> int:
        cap = self.big_capacity
        if cap is None:
            cap = min(max(1024, n // 16), 65536)
        return max(1, min(cap, n))


def grow_for_span_overflow(config: BinningConfig, n: int) -> BinningConfig:
    """Double max_span and the resolved big-class capacity: a span overflow
    is either exhaustion, and doubling both clears whichever fired."""
    return dataclasses.replace(
        config,
        max_span=config.max_span * 2,
        big_capacity=min(config.resolved_big_capacity(n) * 2, n),
    )



def adopt_checkpointed_budget(config: BinningConfig, ckpt_pairs: int, ckpt_span: int,
                              n: int) -> tuple[BinningConfig, bool]:
    """A budget grown before a checkpoint, adopted on resume: ``(config,
    changed)``.  Either budget above the config's triggers it (a run whose
    only growth was of the span would otherwise resume dropping splats);
    ``big_capacity`` is not checkpointed, and span growth doubled it with
    ``max_span``, so it is re-derived from the span ratio."""
    if ckpt_pairs <= config.max_pairs and ckpt_span <= config.max_span:
        return config, False
    if ckpt_span > config.max_span:
        ratio = max(1, ckpt_span // config.max_span)
        config = dataclasses.replace(
            config, big_capacity=min(config.resolved_big_capacity(n) * ratio, n))
    return dataclasses.replace(config, max_pairs=max(ckpt_pairs, config.max_pairs),
                               max_span=max(ckpt_span, config.max_span)), True

def tile_grid(width: int, height: int, tile: int) -> tuple[int, int]:
    return -(-width // tile), -(-height // tile)


def depth_key_tiles(camera: Camera, tile: int) -> int:
    """The tile count whose key field sizes the depth quantization: the
    whole image's (its FOV size), so that a strip of it
    (``dist/tile_sharding.py``) orders equal-looking depths as the whole
    render does; the camera's own for any other camera."""
    tx, ty = tile_grid(camera.fov_width or camera.width, camera.fov_height or camera.height, tile)
    return tx * ty


def _depth_bits_for(num_tiles: int) -> int:
    """Depth bits left in a u32 key after the tile field (which must hold
    num_tiles inclusive, the invalid sentinel); capped at 24."""
    tile_bits = max(1, (num_tiles + 1).bit_length())
    bits = min(32 - tile_bits, 24)
    if bits < 8:
        raise ValueError(f"image too large: {num_tiles} tiles leaves {bits} depth bits")
    return bits


def quantize_depth(d: torch.Tensor, visible: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """(N,) int64 depth bucket over the visible range, as the JAX package
    computes it: (d - dmin) * dscale in float32, clipped at 0, cast, then
    clamped in the integer domain (the product can round up to
    2^depth_bits).  The float clip at 2^32 only guards rows that never emit."""
    n = d.shape[0]
    dmin = torch.where(visible, d, torch.full_like(d, 1e10)).min() if n else d.new_tensor(1e10)
    dmax = torch.where(visible, d, torch.full_like(d, -1e10)).max() if n else d.new_tensor(-1e10)
    limit = (1 << depth_bits) - 1
    dscale = torch.tensor(float(limit), device=d.device) / torch.clamp(dmax - dmin, min=1e-9)
    return torch.clamp(torch.clamp((d - dmin) * dscale, 0.0, 2.0**32).to(torch.int64), max=limit)


@dataclasses.dataclass
class PairStream:
    """Depth-ordered, tile-segmented, chunk-aligned pair stream of one view,
    with the per-Gaussian sources and the gradient routing's aux.  Per-pair
    arrays have the padded length ``config.padded_capacity(num_tiles)``."""

    tile: torch.Tensor          # (Pp,) int32 tile per padded position; num_tiles for padding
    gid: torch.Tensor           # (Pp,) int32 gaussian per padded position (0 for padding)
    g_colors: torch.Tensor      # (N, C)
    g_opacity: torch.Tensor     # (N,) visibility-masked opacity
    start: torch.Tensor         # (T,) int32 chunk-aligned segment starts
    end: torch.Tensor           # (T,) int32 segment ends (start + pairs of the tile)
    emit_offsets: torch.Tensor  # (N,) int32 first emission slot per gaussian
    emit_counts: torch.Tensor   # (N,) int32 emitted slots per gaussian (before budget clipping)
    q_of_slot: torch.Tensor     # (max_pairs,) int32 padded position per emission slot
    total_pairs: torch.Tensor   # () int32 pairs before budget clipping
    overflowed: torch.Tensor    # () bool pair or span budget exceeded
    span_overflowed: torch.Tensor  # () bool the span budget specifically
    splats: Splats2D


def build_pair_stream(args: RenderArgs, camera: Camera, config: BinningConfig) -> PairStream:
    """Preprocess one view and bin it into the padded pair stream.  The
    integers come from detached values; ``g_opacity`` and the splats carry
    autograd history."""
    sp = preprocess(args, camera)
    with torch.no_grad():
        ints = _pair_stream_integers(sp, camera.width, camera.height, config,
                                     depth_key_tiles(camera, config.tile))
    g_opacity = args.opacities[:, 0]
    return PairStream(
        **ints, g_colors=args.colors,
        g_opacity=torch.where(sp.visible, g_opacity, torch.zeros_like(g_opacity)), splats=sp,
    )


def pair_streams(args: RenderArgs, camera: Camera, config: BinningConfig) -> list[PairStream]:
    """The padded pair stream of every view of ``camera``."""
    return [build_pair_stream(args.for_view(i), camera.view(i), config)
            for i in range(camera.num_views)]


def _pair_stream_integers(sp: Splats2D, width: int, height: int, config: BinningConfig,
                          key_tiles: int | None = None) -> dict:
    tiles_x, tiles_y = tile_grid(width, height, config.tile)
    num_tiles = tiles_x * tiles_y
    depth_bits = _depth_bits_for(key_tiles or num_tiles)
    max_span, mp, chunk = config.max_span, config.max_pairs, config.chunk_pairs
    dev = sp.depth.device
    i64 = torch.int64
    n = sp.depth.shape[0]
    vis = sp.visible

    tx0, ty0, tx1, ty1 = tile_rect(sp.mean2d.detach(), sp.radius.detach(), tiles_x, tiles_y,
                                   config.tile)
    span_w = torch.where(vis, tx1 - tx0, torch.zeros_like(tx0)).to(i64)
    span_h = torch.where(vis, ty1 - ty0, torch.zeros_like(ty0)).to(i64)
    count = span_w * span_h
    span_overflow = (count > max_span).any()
    count = torch.clamp(count, max=max_span)
    total_pairs = count.sum()
    ends = torch.cumsum(count, 0)
    offsets = ends - count

    # Emission: gaussian g fills slots offsets[g] + s, s < count[g]; slots
    # past the budget are dropped.  The JAX package scatters all N x
    # max_span lanes into the budget; here each of the max_pairs slots
    # finds its gaussian (the first whose slot range ends past it) and lane,
    # which gives the same keys and ids from max_pairs work instead.
    slot = torch.arange(mp, dtype=i64, device=dev)
    valid = slot < total_pairs
    g = torch.clamp(torch.searchsorted(ends, slot, side="right"), max=max(n - 1, 0))
    s = slot - offsets[g]
    safe_w = torch.clamp(span_w[g], min=1)
    sy = s // safe_w
    tile_id = (ty0.to(i64)[g] + sy) * tiles_x + (tx0.to(i64)[g] + s - sy * safe_w)
    dq = quantize_depth(sp.depth.detach(), vis, depth_bits)
    keys = torch.where(valid, (tile_id << depth_bits) | dq[g], torch.full_like(slot, SENTINEL))
    gids = torch.where(valid, g, torch.zeros_like(g))

    # JAX sorts the u32 keys stably, carrying the slot index; the slot in
    # the low word of one int64 gives the same order (the key biased by
    # 2^31 first, so that keys at and above 2^31 keep their place).
    fused, _ = torch.sort(((keys - (1 << 31)) << 32) | slot)
    keys_sorted = (fused >> 32) + (1 << 31)
    slot_of_p = fused & 0xFFFFFFFF
    gids_sorted = gids[slot_of_p]
    tile_of_pair = torch.clamp(keys_sorted >> depth_bits, max=num_tiles)
    tile_ids = torch.arange(num_tiles, dtype=i64, device=dev)
    start = torch.searchsorted(tile_of_pair, tile_ids, side="left")
    end = torch.searchsorted(tile_of_pair, tile_ids, side="right")

    # Re-align: every tile's segment starts on a chunk boundary.
    padded_cap = config.padded_capacity(num_tiles)
    lengths = end - start
    padded_len = (lengths + chunk - 1) // chunk * chunk
    padded_start = torch.cumsum(padded_len, 0) - padded_len
    t_of_p = torch.clamp(tile_of_pair, max=num_tiles - 1)
    q_p = padded_start[t_of_p] + torch.arange(mp, dtype=i64, device=dev) - start[t_of_p]
    q_of_slot = torch.empty((mp,), dtype=i64, device=dev)
    q_of_slot[slot_of_p] = torch.clamp(q_p, 0, padded_cap - 1)
    q_pos = torch.arange(padded_cap, dtype=i64, device=dev)
    tile_of_q = torch.clamp(
        torch.searchsorted(padded_start, q_pos, side="right") - 1, 0, num_tiles - 1)
    within = q_pos - padded_start[tile_of_q]
    valid = within < lengths[tile_of_q]
    src_p = torch.clamp(start[tile_of_q] + within, 0, mp - 1)
    i32 = torch.int32
    return dict(
        tile=torch.where(valid, tile_of_q, torch.full_like(tile_of_q, num_tiles)).to(i32),
        gid=torch.where(valid, gids_sorted[src_p], torch.zeros_like(src_p)).to(i32),
        start=padded_start.to(i32),
        end=(padded_start + lengths).to(i32),
        emit_offsets=offsets.to(i32),
        emit_counts=count.to(i32),
        q_of_slot=q_of_slot.to(i32),
        total_pairs=total_pairs.to(i32),
        overflowed=span_overflow | (total_pairs > mp),
        span_overflowed=span_overflow,
    )


def gather_pair_records(stream: PairStream, g_colors=None, g_mean2d=None):
    """Per-pair (mean2d, conic, color, opacity, depth) in padded order;
    padding positions get opacity 0, so they never composite.  ``g_colors``
    and ``g_mean2d`` replace the stream's colour source and pixel positions
    (``render_dual``)."""
    g = stream.gid.long()
    sp = stream.splats
    valid = stream.tile < stream.start.shape[0]
    opacity = stream.g_opacity[g]
    mean2d = sp.mean2d if g_mean2d is None else g_mean2d
    colors = stream.g_colors if g_colors is None else g_colors
    return (
        mean2d[g], sp.conic[g], colors[g],
        torch.where(valid, opacity, torch.zeros_like(opacity)), sp.depth[g],
    )
