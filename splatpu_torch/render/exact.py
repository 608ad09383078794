"""Exact-budget tile binning and the batched differentiable render (port of
``splatpu/render/exact.py:93-358`` and ``:1397-1578``).

Binning runs as plain torch on the tensors' device and reproduces the JAX
package's integers exactly: two-class emission (every Gaussian emits
``span_small`` lanes; the few covering more tiles go through a compacted
big class with ``max_span`` lanes), the opacity-aware tile cull, budget
clipping in emission-slot order, one sort of fused (tile | depth, gid | lane)
keys, and per-tile ``[start, end)`` ranges.

The sort.  The JAX package sorts two u32 words (``num_keys=2``).  Here one
int64 holds both: ``((key - 2**31) << 32) | val``.  Biasing the key into the
signed range first matters: at 720p / 32 px tiles the key reaches 2^31 and
above (920 tiles leave 22 depth bits), and the 0xFFFFFFFF sentinel would
otherwise wrap negative and sort first.

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
preprocess by ordinary autograd.
"""

from __future__ import annotations

import dataclasses

import torch

from splatpu_torch.core.projection import Splats2D, preprocess, tile_rect
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.render.binning import (
    KERNEL_CHOICES,
    SENTINEL,
    BinningConfig,
    _depth_bits_for,
    quantize_depth,
    tile_grid,
)
from splatpu_torch.render.composite import (
    BWD_TILES,
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
    config: BinningConfig,
) -> ExactStream:
    """Exact binning of one view's projected splats; ``opacities`` is (N,).

    The integers come from detached values; only ``g_opacity`` (and the
    splats, passed through) carry autograd history."""
    with torch.no_grad():
        stream = _bin(splats, opacities.detach(), width, height, config)
    g_opacity = torch.where(splats.visible, opacities, torch.zeros_like(opacities))
    return dataclasses.replace(stream, g_opacity=g_opacity, splats=splats)


def _bin(splats: Splats2D, opacities, width, height, config: BinningConfig) -> ExactStream:
    splats = Splats2D(
        mean2d=splats.mean2d.detach(), depth=splats.depth.detach(),
        conic=splats.conic.detach(), radius=splats.radius.detach(), visible=splats.visible,
    )
    tile = config.tile
    tiles_x, tiles_y = tile_grid(width, height, tile)
    num_tiles = tiles_x * tiles_y
    depth_bits = _depth_bits_for(num_tiles)
    max_span = config.max_span
    mp = config.max_pairs
    lane_bits = max(1, (max_span - 1).bit_length())
    n = splats.depth.shape[0]
    if n << lane_bits >= 1 << 31:
        raise ValueError("gaussian count * max_span too large for u32 pair values")
    dev = splats.depth.device
    i64 = torch.int64
    vis = splats.visible
    mean2d = splats.mean2d

    tx0, ty0, tx1, ty1 = tile_rect(mean2d, splats.radius, tiles_x, tiles_y, tile)
    zero_i = torch.zeros_like(tx0)
    span_w = torch.where(vis, tx1 - tx0, zero_i)
    span_h = torch.where(vis, ty1 - ty0, zero_i)
    area = span_w * span_h
    count = torch.clamp(area, max=max_span)
    span_overflow = (area > max_span).any()

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

    gids = torch.arange(n, dtype=torch.int32, device=dev)
    span_small = min(config.span_small, max_span)
    two_class = span_small < max_span
    sel_all = lambda x: x  # noqa: E731 — small class: rows are all gaussians
    if two_class:
        cap_b = config.resolved_big_capacity(n)
        is_big = count > span_small
        n_big = is_big.sum()
        bigrank = torch.cumsum(is_big.to(i64), 0) - is_big.to(i64)
        span_overflow = span_overflow | (n_big > cap_b)
        count = torch.where(is_big & (bigrank >= cap_b), zero_i, count)
        # Kept big ids first, in gaussian order (stable sort on the class).
        order = torch.argsort((~is_big).to(torch.int32), stable=True)
        big_ids = order[:cap_b]
        sel_big = lambda x: x[big_ids]  # noqa: E731

        s_a = torch.arange(span_small, dtype=torch.int32, device=dev)[None, :]
        geom_a = lane_geom(sel_all, s_a)
        v_a = lane_keep(
            sel_all, geom_a[0], geom_a[1], (s_a < count[:, None]) & (~is_big)[:, None]
        )
        s_b = torch.arange(max_span, dtype=torch.int32, device=dev)[None, :]
        row_live = (
            torch.arange(cap_b, device=dev) < torch.clamp(n_big, max=cap_b)
        )[:, None]
        geom_b = lane_geom(sel_big, s_b)
        v_b = lane_keep(
            sel_big, geom_b[0], geom_b[1], (s_b < sel_big(count)[:, None]) & row_live
        )
        count_small = v_a.sum(dim=1)
        count_big = v_b.sum(dim=1)
        safe_rank = torch.clamp(bigrank, max=cap_b - 1)
        count = torch.where(
            is_big & (bigrank < cap_b), count_big[safe_rank], count_small
        ).to(torch.int32)
    else:
        s_all = torch.arange(max_span, dtype=torch.int32, device=dev)[None, :]
        geom_all = lane_geom(sel_all, s_all)
        v_all = lane_keep(sel_all, geom_all[0], geom_all[1], s_all < count[:, None])
        count = v_all.sum(dim=1).to(torch.int32)

    total_pairs = count.sum().to(torch.int32)
    offsets = torch.cumsum(count.to(i64), 0) - count.to(i64)

    dq = quantize_depth(splats.depth, vis, depth_bits)

    def emit(sel, g_rows, tile_id, keep):
        keep_i = keep.to(i64)
        rank = torch.cumsum(keep_i, dim=1) - keep_i
        slot = sel(offsets)[:, None] + rank
        ok = keep & (slot < mp)
        key = (tile_id.to(i64) << depth_bits) | sel(dq)[:, None]
        key = torch.where(ok, key, torch.full_like(key, SENTINEL))
        val = (g_rows.to(i64)[:, None] << lane_bits) | rank
        val = torch.where(ok, val, torch.zeros_like(val))
        return key.reshape(-1), val.reshape(-1)

    if two_class:
        key_a, val_a = emit(sel_all, gids, geom_a[2], v_a)
        key_b, val_b = emit(sel_big, big_ids, geom_b[2], v_b)
        key_flat = torch.cat([key_a, key_b])
        val_flat = torch.cat([val_a, val_b])
    else:
        key_flat, val_flat = emit(sel_all, gids, geom_all[2], v_all)

    fused, _ = torch.sort(((key_flat - (1 << 31)) << 32) | val_flat)
    keys_all = (fused >> 32) + (1 << 31)
    vals_all = fused & 0xFFFFFFFF
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
    """Preprocess one view and bin it."""
    sp = preprocess(args, camera)
    return bin_splats(sp, args.opacities[:, 0], camera.width, camera.height, config)


def composite_inputs(args: RenderArgs, camera: Camera, config: BinningConfig):
    """Bin every view of ``camera``: (streams, kernel inputs) where the kernel
    inputs are the stacked ``table``, ``gid``, ``start``, ``end`` and the
    tile ``geometry`` keywords the composite takes."""
    views = [camera.view(i) for i in range(camera.num_views)]
    streams = [build_exact_stream(args, cam, config) for cam in views]
    tiles_x, tiles_y = tile_grid(camera.width, camera.height, config.tile)
    inputs = dict(
        table=torch.stack([
            pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity, s.splats.depth, args.colors)
            for s in streams
        ]),
        gid=torch.stack([s.gid for s in streams]),
        start=torch.stack([s.start for s in streams]),
        end=torch.stack([s.end for s in streams]),
        geometry=dict(
            tiles_x=tiles_x, tiles_y=tiles_y, tile=config.tile,
            width=camera.width, height=camera.height,
        ),
    )
    return streams, inputs


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


def render_exact(
    args: RenderArgs, camera: Camera, bg=None, config: BinningConfig = BinningConfig(),
    impl: str = "cuda",
) -> RenderOutput:
    """Bin every view of ``camera`` and composite all of them in one call:
    the CUDA kernels (``impl="cuda"``) or their plain versions (``"plain"``),
    K1/K2 or K4 as ``config.kernel`` says.  Differentiable in every
    per-Gaussian input of ``args`` and in ``bg``."""
    c = args.colors.shape[1]
    dev = args.means3d.device
    if bg is None:
        bg = torch.zeros((c,), dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev).contiguous()
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown composite impl: {impl!r}")
    check_kernel_limits(config, c)
    differentiable = torch.is_grad_enabled() and (bg.requires_grad or any(
        getattr(args, f.name).requires_grad for f in dataclasses.fields(args)))
    if impl == "cuda" and differentiable and config.tile not in BWD_TILES:
        raise ValueError(f"the CUDA backward composite takes {BWD_TILES} px tiles, got"
                         f" {config.tile}: render without gradients or at one of those tiles")
    streams, k = composite_inputs(args, camera, config)
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
