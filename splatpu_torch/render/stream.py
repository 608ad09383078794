"""Pair-stream tile compositor in plain PyTorch, differentiable by autograd
(port of ``splatpu/render/stream.py``): the port's ``impl="stream"``.

It consumes the padded ``PairStream`` of ``render/binning.py`` in chunks
of ``config.chunk_pairs`` pairs.  Unlike the kernels' serial walk per
pixel, it is pair-parallel: each chunk is evaluated against its own tiles'
pixels as dense (chunk, tile * tile) math, with per-(tile, pixel)
transmittance and termination carried across chunks in log space.  The
serial semantics come back algebraically:

- T_excl(pair) = T_in(tile) * exp(segmented exclusive cumsum of log(1 - alpha));
- a pair fails when T_excl * (1 - alpha) < 1e-4; failure is sticky per
  (tile, pixel) and the failing pair does not composite.

Autograd keeps every chunk's (chunk, tile * tile) intermediates for the
backward, so it suits small scenes (the tests, the CPU); the kernels of
``render/padded.py`` are the card's path over the same stream.  It also
returns the last contributing padded position per pixel, which the padded
kernels return too.
"""

from __future__ import annotations

import torch

from splatpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_EPS
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.render.binning import (
    BinningConfig,
    PairStream,
    gather_pair_records,
    pair_streams,
    tile_grid,
)
from splatpu_torch.render.composite import untile
from splatpu_torch.render.types import RenderOutput


def segmented_exclusive(values: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Per-segment exclusive cumsum along dim 0; ``is_start`` (P,) marks the
    segment starts (index 0 must be one)."""
    cum = torch.cumsum(values, dim=0)
    excl = cum - values
    idx = torch.arange(values.shape[0], device=values.device)
    seg_start = torch.cummax(torch.where(is_start, idx, torch.full_like(idx, -1)), dim=0).values
    return excl - excl[seg_start]


def composite_pairs(stream: PairStream, camera: Camera, config: BinningConfig, bg,
                    g_colors=None, g_mean2d=None):
    """Composite one view's stream: (image (C, H, W), depth (H, W), final T
    (H, W), last padded position (H, W) int32).  ``g_colors`` / ``g_mean2d``
    as in ``gather_pair_records``."""
    r_mean2d, r_conic, r_color, r_opacity, r_depth = gather_pair_records(
        stream, g_colors, g_mean2d)
    tile_px = config.tile
    tiles_x, tiles_y = tile_grid(camera.width, camera.height, tile_px)
    num_tiles = tiles_x * tiles_y
    pc = config.chunk_pairs
    p = stream.tile.shape[0]
    c = r_color.shape[1]
    npix = tile_px * tile_px
    dev = r_color.device

    pix = torch.arange(npix, dtype=torch.float32, device=dev)
    col = pix % tile_px
    row = torch.div(pix, tile_px, rounding_mode="floor")
    # One spare row past the tiles takes the padding pairs (tile == num_tiles).
    log_t = torch.zeros((num_tiles + 1, npix), device=dev)
    failed = torch.zeros((num_tiles + 1, npix), device=dev)
    image = torch.zeros((num_tiles + 1, npix, c), device=dev)
    depth = torch.zeros((num_tiles + 1, npix), device=dev)
    last = torch.full((num_tiles + 1, npix), -1, dtype=torch.int64, device=dev)

    for k0 in range(0, p, pc):
        sl = slice(k0, min(k0 + pc, p))
        tile = stream.tile[sl].long()
        mean2d, conic, color = r_mean2d[sl], r_conic[sl], r_color[sl]
        tx = (tile % tiles_x).float()
        ty = torch.div(tile, tiles_x, rounding_mode="floor").float()
        dx = (tx[:, None] * tile_px + col[None, :]) - mean2d[:, 0:1]   # (pc, npix)
        dy = (ty[:, None] * tile_px + row[None, :]) - mean2d[:, 1:2]
        power = (-0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
                 - conic[:, 1:2] * dx * dy)
        alpha = torch.clamp(r_opacity[sl][:, None] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha,
                            torch.zeros_like(alpha))
        z = torch.log1p(-alpha)
        is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                              tile[1:] != tile[:-1]])
        t_in = torch.exp(log_t[tile] + segmented_exclusive(z, is_start))
        with torch.no_grad():
            fail = t_in * (1.0 - alpha) < TRANSMITTANCE_EPS
            failcum = segmented_exclusive(fail.float(), is_start) + fail.float()
            contribute = (failed[tile] == 0.0) & (failcum == 0.0)
            hit = contribute & (alpha > 0.0)
            pos = torch.arange(k0, sl.stop, device=dev)[:, None].expand_as(hit)
            last.scatter_reduce_(0, tile[:, None].expand_as(pos),
                                 torch.where(hit, pos, torch.full_like(pos, -1)), "amax")
            failed = failed.index_add(0, tile, fail.float())
        w = torch.where(contribute, alpha * t_in, torch.zeros_like(alpha))
        image = image.index_add(0, tile, w[:, :, None] * color[:, None, :])
        depth = depth.index_add(0, tile, w * r_depth[sl][:, None])
        log_t = log_t.index_add(0, tile, torch.where(contribute, z, torch.zeros_like(z)))

    t_final = torch.exp(log_t[:num_tiles])
    image = image[:num_tiles] + t_final[:, :, None] * bg[None, None, :]
    packed = torch.cat([image, depth[:num_tiles, :, None], t_final[:, :, None]], dim=-1)
    full = untile(packed[None], tiles_x, tiles_y, tile_px, camera.width, camera.height)[0]
    last_hw = untile(last[None, :num_tiles, :, None], tiles_x, tiles_y, tile_px,
                     camera.width, camera.height)[0, 0]
    return full[:c], full[c], full[c + 1], last_hw.to(torch.int32)


def stream_output(streams: list[PairStream], outs: list) -> RenderOutput:
    """The ``RenderOutput`` of per-view ``composite_pairs`` results."""
    stack = lambda i: torch.stack([o[i] for o in outs])  # noqa: E731
    return RenderOutput(
        image=stack(0),
        depth=stack(1),
        radii=torch.stack([s.splats.radius for s in streams]),
        final_transmittance=stack(2),
        last_contributor=stack(3),
        overflowed=torch.stack([s.overflowed for s in streams]),
        span_overflowed=torch.stack([s.span_overflowed for s in streams]),
        total_pairs=torch.stack([s.total_pairs for s in streams]),
    )


def render_stream(args: RenderArgs, camera: Camera, bg=None,
                  config: BinningConfig = BinningConfig()) -> RenderOutput:
    """Bin every view of ``camera`` into its pair stream and composite it;
    differentiable in every per-Gaussian input of ``args`` and in ``bg``."""
    dev = args.means3d.device
    if bg is None:
        bg = torch.zeros((args.colors.shape[1],), dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    streams = pair_streams(args, camera, config)
    return stream_output(streams, [composite_pairs(s, camera.view(i), config, bg)
                                   for i, s in enumerate(streams)])
