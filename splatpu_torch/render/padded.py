"""The first-generation padded composite (port of
``splatpu/render/pallas_composite.py``): 16 px tiles over the chunk-aligned
``PairStream`` of ``render/binning.py::build_pair_stream``.

K5 replaces the TPU kernels ``pallas_composite.py::_fwd_kernel`` and
``_bwd_kernel`` (via ``_composite_fwd_call`` / ``_composite_bwd_call``):
``csrc/padded_fwd.cu`` and ``csrc/padded_bwd.cu``, one block per (tile,
view) (the forward 128 threads of two pixels each, the backward 64 of
four), records gathered per pair before the call, segments tested by
``pos < end`` only.  What K5 computes differently from the table composites (K1/K2,
K4) follows its TPU kernel: absolute pixel coordinates, and an opacity row
of sum(exp(power) * dalpha).
Like them, it is bound by its FP32 arithmetic on the H100.

- ``padded_fwd_cuda`` / ``padded_fwd_plain``: records (V, Pp, 7 + C)
  float32, start / end (V, T) int32, bg (C,) -> image (V, C, H, W), depth,
  final T (V, H, W) float32 and the int32 last padded position (V, H, W);
- ``padded_bwd_cuda`` / ``padded_bwd_plain``: + the forward's final T and
  last, cotangents g_img (V, C, H, W), g_depth, g_tf (V, H, W) -> per-pair
  rows (V, Pp, 7 + C), zero at padding and behind every pixel's last.

``CompositeG`` mirrors the ``_composite_g`` custom VJP: the forward
gathers the records by ``gid`` outside the kernel; the backward routes the
per-pair rows back to per-Gaussian rows through ``q_of_slot``, the
emission offsets and counts, with the routing kernel in its padded slot
mode on the card (its plain version on the CPU).  As in the JAX package
(``pallas_composite.py:507-513``), on an overflowed render every slot past
``max_pairs`` reads the last slot's row, once for each such slot.
"""

from __future__ import annotations

import functools

import torch

from splatpu_torch import _build
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.render.binning import BinningConfig, PairStream, pair_streams, tile_grid
from splatpu_torch.render.composite import (
    MAX_C_MANUAL,
    REC_GEOM,
    bwd_walk,
    check_bwd_inputs,
    check_types,
    fwd_walk,
    pack_table,
)
from splatpu_torch.render.route import route_pairs_cuda, route_pairs_plain
from splatpu_torch.render.types import RenderOutput

TILE = 16
MAX_C = MAX_C_MANUAL  # the TPU kernel's NREC - R_COLOR0

LAUNCHES = 0      # kernel launches made by padded_fwd_cuda
BWD_LAUNCHES = 0  # kernel launches made by padded_bwd_cuda


def _check_inputs(records, start, end, bg, tiles_x, tiles_y):
    if records.dim() != 3 or start.dim() != 2 or end.dim() != 2:
        raise ValueError("expected records (V,Pp,R) and start/end (V,T)")
    v, _, rec = records.shape
    c = rec - REC_GEOM
    if not 1 <= c <= MAX_C:
        raise ValueError(f"the padded composite takes 1..{MAX_C} channels, got {c}")
    if start.shape != (v, tiles_x * tiles_y) or end.shape != start.shape:
        raise ValueError("start/end do not match the records' views and tile grid")
    if bg.shape != (c,):
        raise ValueError(f"bg must have shape ({c},), got {tuple(bg.shape)}")
    check_types(records=(records, torch.float32), start=(start, torch.int32),
                end=(end, torch.int32), bg=(bg, torch.float32))
    return v, c


def padded_fwd_cuda(records, start, end, bg, *, tiles_x, tiles_y, width, height):
    """Launch K5's forward; every tensor must be a contiguous CUDA tensor."""
    global LAUNCHES
    _build.require_cuda("padded_fwd_cuda", (records, start, end, bg))
    v, c = _check_inputs(records, start, end, bg, tiles_x, tiles_y)
    dev = records.device
    image = torch.empty((v, c, height, width), dtype=torch.float32, device=dev)
    depth = torch.empty((v, height, width), dtype=torch.float32, device=dev)
    tfin = torch.empty_like(depth)
    last = torch.empty((v, height, width), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.splatpu_padded_fwd(
            records.data_ptr(), start.data_ptr(), end.data_ptr(), bg.data_ptr(),
            image.data_ptr(), depth.data_ptr(), tfin.data_ptr(), last.data_ptr(),
            v, records.shape[1], c, tiles_x, tiles_y, width, height, stream,
        )
    _build.check_status(lib, code, "padded_fwd launch")
    LAUNCHES += 1
    return image, depth, tfin, last


def records_fetch(records):
    """``fwd_walk``'s record fetch for K5: the pre-gathered row at each position."""
    v, pp, rec_n = records.shape
    flat = records.reshape(v * pp, rec_n)
    return lambda view, pos: flat[view * pp + pos]


def padded_fwd_plain(records, start, end, bg, *, tiles_x, tiles_y, width, height,
                     chunk: int = 256, with_counts: bool = False):
    """K5's forward in plain PyTorch (``composite.fwd_walk`` in absolute
    pixel coordinates)."""
    v, c = _check_inputs(records, start, end, bg, tiles_x, tiles_y)
    return fwd_walk(records_fetch(records), start, end, bg, v=v, c=c, tiles_x=tiles_x,
                    tiles_y=tiles_y, tile=TILE, width=width, height=height, padded=True,
                    chunk=chunk, with_counts=with_counts)


def padded_bwd_cuda(records, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
                    *, tiles_x, tiles_y, width, height):
    """Launch K5's backward; every tensor must be a contiguous CUDA tensor.
    Returns the per-pair rows (V, Pp, 7 + C), zero where no pixel
    composited the pair."""
    global BWD_LAUNCHES
    tensors = (records, start, end, bg, tfinal, last, g_img, g_depth, g_tf)
    _build.require_cuda("padded_bwd_cuda", tensors)
    v, c = _check_inputs(records, start, end, bg, tiles_x, tiles_y)
    check_bwd_inputs(tfinal, last, g_img, g_depth, g_tf, v, c, width, height)
    d_rows = torch.zeros_like(records)
    lib = _build.load_library()
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream(records.device).cuda_stream
        code = lib.splatpu_padded_bwd(
            *(x.data_ptr() for x in tensors), d_rows.data_ptr(), v, records.shape[1], c,
            tiles_x, tiles_y, width, height, stream,
        )
    _build.check_status(lib, code, "padded_bwd launch")
    BWD_LAUNCHES += 1
    return d_rows


def padded_bwd_plain(records, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
                     *, tiles_x, tiles_y, width, height, chunk: int = 256):
    """K5's backward in plain PyTorch (``composite.bwd_walk`` in absolute
    pixel coordinates, with K5's opacity row)."""
    v, c = _check_inputs(records, start, end, bg, tiles_x, tiles_y)
    check_bwd_inputs(tfinal, last, g_img, g_depth, g_tf, v, c, width, height)
    return bwd_walk(records_fetch(records), start, end, bg, tfinal, last, g_img, g_depth, g_tf,
                    v=v, c=c, p=records.shape[1], tiles_x=tiles_x, tiles_y=tiles_y, tile=TILE,
                    width=width, height=height, padded=True, chunk=chunk)


# impl -> (forward composite, backward composite, routing in its padded mode)
KERNELS = {
    "cuda": (padded_fwd_cuda, padded_bwd_cuda, functools.partial(route_pairs_cuda, padded=True)),
    "plain": (padded_fwd_plain, padded_bwd_plain,
              functools.partial(route_pairs_plain, padded=True)),
}


class CompositeG(torch.autograd.Function):
    """The batched padded composite over the per-Gaussian table (V, N,
    7 + C) (``composite.pack_table``), differentiable in the table and in
    ``bg`` (C,).  Outputs image (V, C, H, W), depth and final T (V, H, W),
    and the int32 last padded position (not differentiable)."""

    @staticmethod
    def forward(ctx, table, bg, gid, start, end, q_of_slot, offsets, counts, geometry, impl):
        fwd = KERNELS[impl][0]
        rows = torch.arange(table.shape[0], device=table.device)[:, None]
        records = table[rows, gid.long()].contiguous()
        image, depth, tfin, last = fwd(records, start, end, bg, **geometry)
        ctx.save_for_backward(records, bg, start, end, q_of_slot, offsets, counts, tfin, last)
        ctx.geometry = geometry
        ctx.impl = impl
        ctx.mark_non_differentiable(last)
        return image, depth, tfin, last

    @staticmethod
    def backward(ctx, g_img, g_depth, g_tf, _g_last):
        records, bg, start, end, q_of_slot, offsets, counts, tfin, last = ctx.saved_tensors
        _, bwd, route = KERNELS[ctx.impl]
        rows = bwd(records, start, end, bg, tfin, last, g_img.contiguous(),
                   g_depth.contiguous(), g_tf.contiguous(), **ctx.geometry)
        d_table = route(rows, q_of_slot, offsets, counts)
        d_bg = (g_img * tfin[:, None]).sum(dim=(0, 2, 3))
        return d_table, d_bg, None, None, None, None, None, None, None, None


def composite_stream(streams: list[PairStream], camera: Camera, config: BinningConfig, bg,
                     impl: str = "cuda", g_colors=None, g_mean2d=None) -> RenderOutput:
    """Composite the pre-built pair streams of ``camera``'s views (one per
    view) in one call: K5 (``impl="cuda"``) or its plain versions
    (``"plain"``).  ``g_colors`` (N, C) and ``g_mean2d`` (per view, (N, 2))
    replace the streams' colours and pixel positions
    (``splatpu/render/pallas_composite.py:555-567``; ``render_dual``)."""
    colors = streams[0].g_colors if g_colors is None else g_colors
    c = colors.shape[1]
    if c > MAX_C:
        raise ValueError(f"at most {MAX_C} color channels supported")
    if config.tile != TILE:
        raise ValueError(
            "the first-generation padded path is fixed at 16x16 tiles; use"
            " impl='pallas' for configurable tile sizes"
        )
    if impl not in KERNELS:
        raise ValueError(f"unknown composite impl: {impl!r}")
    dev = streams[0].gid.device
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev).contiguous()
    tiles_x, tiles_y = tile_grid(camera.width, camera.height, TILE)
    table = torch.stack([
        pack_table(s.splats.mean2d if g_mean2d is None else g_mean2d[i], s.splats.conic,
                   s.g_opacity, s.splats.depth, colors)
        for i, s in enumerate(streams)
    ])
    gid = torch.stack([s.gid for s in streams])
    stack = lambda f: torch.stack([getattr(s, f) for s in streams])  # noqa: E731
    image, depth, tfin, last = CompositeG.apply(
        table, bg, gid, stack("start"), stack("end"), stack("q_of_slot"), stack("emit_offsets"),
        stack("emit_counts"),
        dict(tiles_x=tiles_x, tiles_y=tiles_y, width=camera.width, height=camera.height), impl,
    )
    return RenderOutput(
        image=image,
        depth=depth,
        radii=torch.stack([s.splats.radius for s in streams]),
        final_transmittance=tfin,
        last_contributor=last,
        overflowed=stack("overflowed"),
        span_overflowed=stack("span_overflowed"),
        total_pairs=stack("total_pairs"),
    )


def render_padded(args: RenderArgs, camera: Camera, bg=None,
                  config: BinningConfig = BinningConfig(), impl: str = "cuda") -> RenderOutput:
    """Bin every view of ``camera`` into the padded pair stream and
    composite them in one call.  Differentiable in every per-Gaussian input
    of ``args`` and in ``bg``."""
    if bg is None:
        bg = torch.zeros((args.colors.shape[1],), dtype=torch.float32, device=args.means3d.device)
    return composite_stream(pair_streams(args, camera, config), camera, config, bg, impl=impl)
