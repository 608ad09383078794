"""Exact-budget tile binning and the batched differentiable render (port of
``splatpu/render/exact.py:93-358`` and ``:1397-1578``).

Binning runs as plain torch on the tensors' device: one lane per covered
tile of each Gaussian, the opacity-aware tile cull, budget clipping in
emission-slot order, one sort of fused (tile | depth, gid | lane) keys, and
per-tile ``[start, end)`` ranges.

The lanes are one pool: every Gaussian takes as many lanes as it covers
tiles, packed end to end into the ``n x span_small + big_capacity x
max_span`` lanes of the JAX package's two classes (each Gaussian's
``span_small`` lanes, and ``max_span`` for each of the few wider ones).
So a Gaussian wider than ``max_span`` tiles emits every tile of its
rectangle that the cull keeps, and the pairs and their order are those of
an uncapped binning.  Only the pool can drop pairs, where its lanes or the
pair value's lane field run out; either is flagged as ``span_overflowed``
in the view that overflows.  Where no Gaussian is wider than ``max_span``
and the big class's rows hold, the integers are the JAX package's exactly
(``exact_tie_order=False`` orders the pool's rows small class first, as
the JAX package emits); ``BinningConfig(clamp_span=True)`` gives its span
budget everywhere (a wider Gaussian's tiles past ``max_span`` dropped, big
Gaussians past ``big_capacity`` dropped, both flagged), which the parity
tests hold.  The pool's emission is a ``record_function`` range
``wide_emit``; while a profiler records, the pairs of Gaussians wider than
``max_span`` are counted for ``obs.profiling.take_counts``.

The sort.  The JAX package sorts two u32 words (``num_keys=2``).  Here one
int64 holds both: ``((key - 2**31) << 32) | val``.  Biasing the key into the
signed range first matters: at 720p / 32 px tiles the key reaches 2^31 and
above (920 tiles leave 22 depth bits), and the 0xFFFFFFFF sentinel would
otherwise wrap negative and sort first.  Under
``BinningConfig(exact_tie_order=False)`` the JAX package sorts the key word
alone with a stable sort (``num_keys=1``), so tied pairs keep their
emission order, class A's before class B's; here a stable sort of the
int64 key (no bias needed: it holds the u32 as is) carries the values.

The render.  ``CompositeTable`` is the port of the ``_composite_table``
custom VJP: its forward is the forward composite, its backward the
backward composite -> ``pos_of_slot_of`` -> the routing kernel, giving
d(table) (V, N, 7 + C) and d(bg).  ``config.kernel`` picks the composite
as the JAX package's does: ``"grid"`` runs K1/K2 (at most 5 colour
channels and 2^24 pairs, the JAX grid kernel's limits, with its error
messages), ``"manual"`` runs K4 (up to 9 channels, any budget).  Binning
computes integers only and runs without autograd; the per-Gaussian table
is packed from ``preprocess``'s outputs by differentiable ops, so
gradients reach means, rotations, scales, opacities and colours through
preprocess by ordinary autograd.  ``render_exact`` (and ``render_dual``)
under ``impl="cuda"`` projects and packs every view in one autograd node
instead (``render/project.py``: one kernel launch forward, one backward)
and bins each view from slices of its outputs.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from splatpu_torch.core.projection import Splats2D, preprocess, tile_rect
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.obs import profiling
from splatpu_torch.render.binning import (
    KERNEL_CHOICES,
    SENTINEL,
    BinningConfig,
    _depth_bits_for,
    depth_key_tiles,
    quantize_depth,
    tile_grid,
)
from splatpu_torch.render.composite import (
    MAX_C,
    MAX_C_MANUAL,
    composite_bwd_cuda,
    composite_bwd_plain,
    composite_fwd_cuda,
    composite_fwd_plain,
    composite_manual_bwd_cuda,
    composite_manual_bwd_plain,
    composite_manual_fwd_cuda,
    composite_manual_fwd_plain,
    pack_table,
)
from splatpu_torch.render.project import project_views
from splatpu_torch.render.route import pos_of_slot_of, route_pairs_cuda, route_pairs_plain
from splatpu_torch.render.types import RenderOutput


@dataclasses.dataclass
class ExactStream:
    """Depth-sorted, tile-ranged pair stream of one view."""

    gid: torch.Tensor          # (P,) int32 gaussian per sorted pair (0 for pad)
    start: torch.Tensor        # (T,) int32
    end: torch.Tensor          # (T,) int32
    lane: torch.Tensor         # (P,) int32 emission lane, -1 for pad / dropped
    offsets: torch.Tensor      # (N,) int32 first emission slot per gaussian
    counts: torch.Tensor       # (N,) int32 emitted pairs per gaussian
    g_opacity: torch.Tensor    # (N,) visibility-masked opacity
    total_pairs: torch.Tensor  # () int32 pairs before budget clipping
    overflowed: torch.Tensor   # () bool any budget exceeded
    span_overflowed: torch.Tensor  # () bool the span budget specifically
    splats: Splats2D


def bin_splats(
    splats: Splats2D, opacities: torch.Tensor, width: int, height: int,
    config: BinningConfig, key_tiles: int | None = None,
) -> ExactStream:
    """Exact binning of one view's projected splats; ``opacities`` is (N,).
    ``key_tiles`` (default: the image's tile count) sizes the sort key's
    tile field and so the depth quantization (``binning.depth_key_tiles``).

    The integers come from detached values; only ``g_opacity`` (and the
    splats, passed through) carry autograd history.  While a profiler
    records, the view's pairs, lane slots, budget and wide pairs are kept
    for ``obs.profiling.take_counts``."""
    with torch.no_grad():
        stream = _bin(splats, opacities.detach(), width, height, config, key_tiles)
    g_opacity = torch.where(splats.visible, opacities, torch.zeros_like(opacities))
    return dataclasses.replace(stream, g_opacity=g_opacity, splats=splats)


def _bin(splats: Splats2D, opacities, width, height, config: BinningConfig,
         key_tiles: int | None = None) -> ExactStream:
    splats = Splats2D(
        mean2d=splats.mean2d.detach(), depth=splats.depth.detach(),
        conic=splats.conic.detach(), radius=splats.radius.detach(), visible=splats.visible,
    )
    tile = config.tile
    tiles_x, tiles_y = tile_grid(width, height, tile)
    num_tiles = tiles_x * tiles_y
    depth_bits = _depth_bits_for(key_tiles or num_tiles)
    max_span = config.max_span
    mp = config.max_pairs
    n = splats.depth.shape[0]
    base_bits = max(1, (max_span - 1).bit_length())
    if n << base_bits >= 1 << 31:
        raise ValueError("gaussian count * max_span too large for u32 pair values")
    if config.clamp_span:
        lane_bits = base_bits
    else:
        # A big-class row may take every tile of the image, as far as the
        # pair value's lane field (beside the gaussian id) holds its lanes.
        lane_bits = max(base_bits, min((num_tiles - 1).bit_length(), 31 - n.bit_length()))
    row_cap = max_span if config.clamp_span else 1 << lane_bits
    dev = splats.depth.device
    i64 = torch.int64
    vis = splats.visible
    mean2d = splats.mean2d

    tx0, ty0, tx1, ty1 = tile_rect(mean2d, splats.radius, tiles_x, tiles_y, tile)
    zero_i = torch.zeros_like(tx0)
    span_w = torch.where(vis, tx1 - tx0, zero_i)
    span_h = torch.where(vis, ty1 - ty0, zero_i)
    area = span_w * span_h
    count = torch.clamp(area, max=row_cap)
    span_overflow = (area > row_cap).any()

    if config.cull_tiles:
        op_act = torch.where(vis, opacities, torch.zeros_like(opacities))
        r3 = splats.radius / torch.tensor(3.0, device=dev)
        lam_max = r3 * r3
        log_term = torch.log(torch.clamp(255.0 * op_act, min=1e-12))
        r_eff2 = torch.clamp(2.0 * lam_max * log_term, min=0.0)

    inv_w = 1.0 / torch.clamp(span_w, min=1).float()

    def lane_geom(sel, s):
        sy = torch.floor((s.float() + 0.5) * sel(inv_w)[:, None]).to(torch.int32)
        sx = s - sy * sel(span_w)[:, None]
        tile_id = (sel(ty0)[:, None] + sy) * tiles_x + (sel(tx0)[:, None] + sx)
        return sx, sy, tile_id

    def lane_keep(sel, sx, sy, in_rect):
        if not config.cull_tiles:
            return in_rect
        tl = float(tile)
        x0 = (sel(tx0)[:, None] + sx).float() * tl
        y0 = (sel(ty0)[:, None] + sy).float() * tl
        m2 = sel(mean2d)
        mx = m2[:, 0][:, None]
        my = m2[:, 1][:, None]
        dx = mx - torch.minimum(torch.maximum(mx, x0), x0 + (tl - 1.0))
        dy = my - torch.minimum(torch.maximum(my, y0), y0 + (tl - 1.0))
        return in_rect & (dx * dx + dy * dy <= sel(r_eff2)[:, None])

    span_small = min(config.span_small, max_span)
    cap_b = config.resolved_big_capacity(n)
    if config.clamp_span:
        # The JAX package's big class holds cap_b rows; later big Gaussians
        # emit nothing and flag the span budget.
        is_big = (count > span_small).to(i64)
        dropped = (torch.cumsum(is_big, 0) > cap_b) & (is_big > 0)
        span_overflow = span_overflow | dropped.any()
        count = torch.where(dropped, 0, count)
    with record_function("wide_emit"):
        # Every Gaussian's lanes, as many as it covers tiles, packed end to
        # end into the n * span_small + cap_b * max_span lanes of the two
        # classes; lane j is lane s of pool row r.  Rows are Gaussians in
        # index order, or (``exact_tie_order=False``, whose ties keep the
        # emission order) the small class's before the big class's.
        pool = n * span_small + cap_b * max_span if n else 0
        rows = None if config.exact_tie_order else torch.argsort(
            (count > span_small).to(torch.int32), stable=True)
        lanes = (count if rows is None else count[rows]).to(i64)
        ends = torch.cumsum(lanes, 0)
        used = ends[-1] if n else ends.new_zeros(())
        span_overflow = span_overflow | (used > pool)
        j = torch.arange(pool, dtype=i64, device=dev)
        row = torch.searchsorted(ends[:-1], j, right=True)   # at most n - 1
        g = row if rows is None else rows[row]
        sel = lambda x: x[g]  # noqa: E731
        starts = torch.clamp(ends - lanes, max=pool)
        first = starts[row]
        sx, sy, tile_id = lane_geom(sel, (j - first)[:, None])
        keep = lane_keep(sel, sx, sy, (j < used)[:, None])
        # Each lane's rank among its row's kept lanes, and each row's count:
        # differences of the kept lanes' running count (rows are contiguous).
        kept = torch.cumsum(torch.cat([keep.new_zeros(1), keep[:, 0]]), 0)
        rank = (kept[:-1] - kept[first])[:, None]
        count = kept[torch.clamp(ends, max=pool)] - kept[starts]
        if rows is not None:
            count = torch.empty_like(count).index_copy_(0, rows, count)

    total_pairs = count.sum().to(torch.int32)
    offsets = torch.cumsum(count, 0) - count
    dq = quantize_depth(splats.depth, vis, depth_bits)
    with record_function("wide_emit"):
        slot = sel(offsets)[:, None] + rank
        ok = keep & (slot < mp)
        key = (tile_id.to(i64) << depth_bits) | sel(dq)[:, None]
        key_flat = torch.where(ok, key, SENTINEL).reshape(-1)
        val = (g[:, None] << lane_bits) | rank
        val_flat = torch.where(ok, val, 0).reshape(-1)
    if torch.autograd._profiler_enabled():
        wide = (count * (area > max_span)).sum()
        profiling.count_binning(total_pairs, key_flat.numel(), mp, wide)

    if config.exact_tie_order:
        fused, _ = torch.sort(((key_flat - (1 << 31)) << 32) | val_flat)
        keys_all = (fused >> 32) + (1 << 31)
        vals_all = fused & 0xFFFFFFFF
    else:
        keys_all, order = torch.sort(key_flat, stable=True)
        vals_all = val_flat[order]
    if keys_all.shape[0] >= mp:
        keys_sorted, vals_sorted = keys_all[:mp], vals_all[:mp]
    else:
        pad = mp - keys_all.shape[0]
        keys_sorted = torch.cat([keys_all, torch.full((pad,), SENTINEL, dtype=i64, device=dev)])
        vals_sorted = torch.cat([vals_all, torch.zeros((pad,), dtype=i64, device=dev)])

    tile_of_pair = torch.clamp(keys_sorted >> depth_bits, max=num_tiles)
    bounds = torch.searchsorted(
        tile_of_pair, torch.arange(num_tiles + 1, dtype=i64, device=dev), side="left"
    ).to(torch.int32)
    gid_sorted = (vals_sorted >> lane_bits).to(torch.int32)
    lane_sorted = (vals_sorted & ((1 << lane_bits) - 1)).to(torch.int32)
    valid_p = keys_sorted != SENTINEL
    lane_tag = torch.where(valid_p, lane_sorted, torch.full_like(lane_sorted, -1))

    return ExactStream(
        gid=gid_sorted.contiguous(),
        start=bounds[:-1].contiguous(),
        end=bounds[1:].contiguous(),
        lane=lane_tag,
        offsets=offsets.to(torch.int32),
        counts=count.to(torch.int32),
        g_opacity=torch.where(vis, opacities, torch.zeros_like(opacities)),
        total_pairs=total_pairs,
        overflowed=span_overflow | (total_pairs > mp),
        span_overflowed=span_overflow,
        splats=splats,
    )


def build_exact_stream(args: RenderArgs, camera: Camera, config: BinningConfig) -> ExactStream:
    """Preprocess one view and bin it (``record_function`` ranges
    ``preprocess`` and ``binning``)."""
    with record_function("preprocess"):
        sp = preprocess(args, camera)
    with record_function("binning"):
        return bin_splats(sp, args.opacities[:, 0], camera.width, camera.height, config,
                          depth_key_tiles(camera, config.tile))


def bin_views(args: RenderArgs, camera: Camera, config: BinningConfig) -> list[ExactStream]:
    """Preprocess and bin every view of ``camera`` (each view with its own
    slice of a per-view ``means2d_offset``)."""
    return [build_exact_stream(args.for_view(i), camera.view(i), config)
            for i in range(camera.num_views)]


def bin_projected(args: RenderArgs, camera: Camera, config: BinningConfig, table, radius,
                  visible) -> list[ExactStream]:
    """Bin every view of ``camera`` from its slices of ``project_views``'
    outputs (a ``record_function`` range ``binning`` per view), as
    ``bin_splats`` bins ``preprocess``'s: the same integers.  Each stream's
    ``g_opacity`` and splats are the table's columns."""
    streams = []
    opacities = args.opacities[:, 0].detach()
    key_tiles = depth_key_tiles(camera, config.tile)
    for i in range(camera.num_views):
        splats = Splats2D(mean2d=table[i, :, 0:2], depth=table[i, :, 6], conic=table[i, :, 2:5],
                          radius=radius[i], visible=visible[i])
        with record_function("binning"), torch.no_grad():
            stream = _bin(splats, opacities, camera.width, camera.height, config, key_tiles)
        streams.append(dataclasses.replace(stream, g_opacity=table[i, :, 5], splats=splats))
    return streams


def table_inputs(streams: list[ExactStream], camera: Camera, config: BinningConfig, colors,
                 mean2d=None, table=None) -> dict:
    """The composite's kernel inputs over binned views: the stacked
    ``table`` packed from each view's splats with ``colors`` (N, C) (or
    ``table``, packed already), the stacked ``gid``, ``start``, ``end``,
    the tile ``geometry`` keywords.  ``mean2d``: per-view (N, 2) pixel
    positions in place of the splats' (``render_dual``'s secondary
    lineage)."""
    tiles_x, tiles_y = tile_grid(camera.width, camera.height, config.tile)
    return dict(
        table=table if table is not None else torch.stack([
            pack_table(s.splats.mean2d if mean2d is None else mean2d[i], s.splats.conic,
                       s.g_opacity, s.splats.depth, colors)
            for i, s in enumerate(streams)
        ]),
        gid=torch.stack([s.gid for s in streams]),
        start=torch.stack([s.start for s in streams]),
        end=torch.stack([s.end for s in streams]),
        geometry=dict(
            tiles_x=tiles_x, tiles_y=tiles_y, tile=config.tile,
            width=camera.width, height=camera.height,
        ),
    )


def composite_inputs(args: RenderArgs, camera: Camera, config: BinningConfig):
    """Bin every view of ``camera``: (streams, ``table_inputs`` with
    ``args.colors``)."""
    streams = bin_views(args, camera, config)
    return streams, table_inputs(streams, camera, config, args.colors)


# (impl, config.kernel) -> (forward composite, backward composite, routing)
KERNELS = {
    ("cuda", "grid"): (composite_fwd_cuda, composite_bwd_cuda, route_pairs_cuda),
    ("cuda", "manual"): (composite_manual_fwd_cuda, composite_manual_bwd_cuda, route_pairs_cuda),
    ("plain", "grid"): (composite_fwd_plain, composite_bwd_plain, route_pairs_plain),
    ("plain", "manual"): (
        composite_manual_fwd_plain, composite_manual_bwd_plain, route_pairs_plain),
}


def check_kernel_limits(config: BinningConfig, c: int) -> None:
    """The JAX package's guards on the exact path's composite
    (``splatpu/render/exact.py:1491, 1518-1533``), with its messages."""
    if config.kernel not in KERNEL_CHOICES:
        raise ValueError(f"unknown composite kernel {config.kernel!r}; expected {KERNEL_CHOICES}")
    if config.kernel == "grid" and c > MAX_C:
        raise ValueError(
            f"the grid kernel's packed output supports at most {MAX_C} color"
            f" channels (got {c}); use kernel='manual' for more"
        )
    if config.kernel == "grid" and config.max_pairs > 1 << 24:
        raise ValueError(
            "kernel='grid' supports max_pairs <= 2^24 (f32-exact pair"
            f" positions); got {config.max_pairs}. Use kernel='manual'."
        )
    if c > MAX_C_MANUAL:
        raise ValueError(f"at most {MAX_C_MANUAL} color channels supported")


class CompositeTable(torch.autograd.Function):
    """The batched composite over the per-Gaussian table, differentiable in
    ``table`` (V, N, 7 + C) and ``bg`` (C,).  Outputs image (V, C, H, W),
    depth and final T (V, H, W), and the int32 last contributor (not
    differentiable)."""

    @staticmethod
    def forward(ctx, table, bg, gid, start, end, offsets, counts, lane, geometry, impl):
        """``impl`` is a key of ``KERNELS``."""
        fwd = KERNELS[impl][0]
        image, depth, tfin, last = fwd(table, gid, start, end, bg, **geometry)
        ctx.save_for_backward(table, bg, gid, start, end, offsets, counts, lane, tfin, last)
        ctx.geometry = geometry
        ctx.impl = impl
        ctx.mark_non_differentiable(last)
        return image, depth, tfin, last

    @staticmethod
    def backward(ctx, g_img, g_depth, g_tf, _g_last):
        table, bg, gid, start, end, offsets, counts, lane, tfin, last = ctx.saved_tensors
        _, bwd, route = KERNELS[ctx.impl]
        rows = bwd(
            table, gid, start, end, bg, tfin, last, g_img.contiguous(),
            g_depth.contiguous(), g_tf.contiguous(), **ctx.geometry,
        )
        d_table = route(rows, pos_of_slot_of(offsets, gid, lane), offsets, counts)
        d_bg = (g_img * tfin[:, None]).sum(dim=(0, 2, 3))
        return d_table, d_bg, None, None, None, None, None, None, None, None


def composite_streams(streams: list[ExactStream], camera: Camera, config: BinningConfig, bg,
                      colors, impl: str = "cuda", mean2d=None, table=None) -> RenderOutput:
    """Composite binned views in one call, the table packed with ``colors``
    (and ``mean2d``, see ``table_inputs``) or ``table`` as given: the CUDA
    kernels (``impl="cuda"``) or their plain versions (``"plain"``), K1/K2
    or K4 as ``config.kernel`` says.  A ``record_function`` range
    ``composite``."""
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown composite impl: {impl!r}")
    check_kernel_limits(config, colors.shape[1])
    with record_function("composite"):
        k = table_inputs(streams, camera, config, colors, mean2d, table)
        offsets = torch.stack([s.offsets for s in streams])
        counts = torch.stack([s.counts for s in streams])
        lane = torch.stack([s.lane for s in streams])
        image, depth, tfin, last = CompositeTable.apply(
            k["table"], bg, k["gid"], k["start"], k["end"], offsets, counts, lane,
            k["geometry"], (impl, config.kernel),
        )
        return RenderOutput(
            image=image,
            depth=depth,
            radii=torch.stack([s.splats.radius for s in streams]),
            final_transmittance=tfin,
            last_contributor=last,
            overflowed=torch.stack([s.overflowed for s in streams]),
            span_overflowed=torch.stack([s.span_overflowed for s in streams]),
            total_pairs=torch.stack([s.total_pairs for s in streams]),
        )


def background(bg, c: int, device) -> torch.Tensor:
    """``bg`` as a contiguous float32 (C,) tensor on ``device``; zeros for None."""
    if bg is None:
        return torch.zeros((c,), dtype=torch.float32, device=device)
    return torch.as_tensor(bg, dtype=torch.float32, device=device).contiguous()


def render_exact(
    args: RenderArgs, camera: Camera, bg=None, config: BinningConfig = BinningConfig(),
    impl: str = "cuda",
) -> RenderOutput:
    """Bin every view of ``camera`` and composite all of them in one call
    (``composite_streams``).  Under ``impl="cuda"`` the views are projected
    and packed by one kernel launch (``project_views``, in one
    ``record_function`` range ``preprocess``), otherwise by ``preprocess``
    per view.  Differentiable in every per-Gaussian input of ``args`` and in
    ``bg``."""
    c = args.colors.shape[1]
    bg = background(bg, c, args.means3d.device)
    check_kernel_limits(config, c)  # before binning: a refused budget bins nothing
    if impl != "cuda":
        return composite_streams(bin_views(args, camera, config), camera, config, bg,
                                 args.colors, impl=impl)
    with record_function("preprocess"):
        table, radius, visible = project_views(args, camera)
    streams = bin_projected(args, camera, config, table, radius, visible)
    return composite_streams(streams, camera, config, bg, args.colors, impl=impl, table=table)
