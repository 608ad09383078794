"""Tile-axis sharding: one render split across the ranks of the ``tiles``
axis by image rows (port of ``splatpu/dist/tile_sharding.py``).

A strip is the whole camera with ``height = strip_height(...)``, the whole
image's size as its FOV size and its first row as ``Camera.row_offset``:
it projects as the whole image does (``K``, the frustum clamp and the
``means2d_offset`` pixel scale of the whole image) and moves the pixel
positions up by its first row, exactly, so its pixels are the whole
render's rows bit for bit.  (The JAX package moves the principal point
instead, cy' = cy - row0, and projects with the strip's height; that
rounds each position differently, and on a full-width view some pixels'
1/255 alpha cut or termination falls the other way.)  Strips start on the
tile grid, so each strip's tiles are the whole render's tiles; a strip
ends where the image does (the last strip is shorter, and padded with
zero rows for the gather), so its tiles cover the rows the whole render's
do; and its sort key quantizes depths with the whole image's tile count
(``binning.depth_key_tiles``), so near-equal depths keep the whole
render's order.  The Gaussians are replicated; each rank bins and
composites only its strip.

JAX's ``shard_map`` returns the strips as one array sharded over the axis
and, under ``grad``, sums the replicated inputs' gradients over the axis
(the transpose of their broadcast).  Here the strips are gathered into the
whole image on every rank (``gather_rows``, whose backward takes this
rank's own rows of the whole-image cotangent: every rank computes the same
whole-image loss, so summing the cotangents over the ranks, as
``torch.distributed.nn``'s all_gather does, would count each strip once per
rank), and the renders' inputs pass through ``replicated``, whose backward
sums their gradients over the axis in one all-reduce.
"""

from __future__ import annotations

import dataclasses

import torch

from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.dist.mesh import Mesh
from splatpu_torch.render.api import render, render_dual
from splatpu_torch.render.binning import DEFAULT_TILE
from splatpu_torch.render.types import RenderOutput


def strip_height(height: int, n_shards: int, tile: int = DEFAULT_TILE) -> int:
    """Rows per shard: tile-aligned, covering the (padded) image."""
    tiles_y = -(-height // tile)
    tiles_per_shard = -(-tiles_y // n_shards)
    return tiles_per_shard * tile


def strip_camera(camera: Camera, sh: int, row0: int) -> Camera:
    """The ``sh`` rows of ``camera``'s image from row ``row0``, cut where
    the image ends (at least one row: a strip wholly below the image
    renders one row that the caller crops)."""
    rows = max(1, min(sh, camera.height - row0))
    return dataclasses.replace(camera, height=rows, fov_width=camera.fov_width or camera.width,
                               fov_height=camera.fov_height or camera.height,
                               row_offset=camera.row_offset + row0)


def pad_rows(x: torch.Tensor, sh: int) -> torch.Tensor:
    """``x`` (..., rows, W) padded with zero rows to ``sh`` rows."""
    return torch.nn.functional.pad(x, (0, 0, 0, sh - x.shape[-2])) if x.shape[-2] < sh else x


class _GatherRows(torch.autograd.Function):
    """The tile ranks' strips (..., sh, W) -> the whole (..., T sh, W) on
    every rank; backward: this rank's own rows of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        t, sh = mesh.tile_index, x.shape[-2]
        ctx.rows = (t * sh, (t + 1) * sh)
        return torch.cat(list(mesh.all_gather(x, "tiles").unbind(0)), dim=-2)

    @staticmethod
    def backward(ctx, grad):
        r0, r1 = ctx.rows
        return grad[..., r0:r1, :].contiguous(), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.tiles == 1 else _GatherRows.apply(x, mesh)


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward: the gradient summed over ``axis``."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone(), "sum", ctx.axis), None, None


def replicated(tensors: list, mesh: Mesh, axis: str = "tiles") -> list:
    """``tensors`` as they are, with their gradients summed over ``axis``
    in one all-reduce (None entries stay None)."""
    live = [t for t in tensors if t is not None]
    if mesh.shape[axis] == 1 or not live:
        return tensors
    flat = _SumGrad.apply(torch.cat([t.reshape(-1) for t in live]), mesh, axis)
    parts = iter(flat.split([t.numel() for t in live]))
    return [None if t is None else next(parts).view_as(t) for t in tensors]


def _replicated_args(args: RenderArgs, extra: list, mesh: Mesh, axis: str):
    fields = ("means3d", "colors", "rotations", "opacities", "scales", "means2d_offset")
    out = replicated([getattr(args, f) for f in fields] + extra, mesh, axis)
    return RenderArgs(**dict(zip(fields, out[:len(fields)]))), out[len(fields):]


def _strip(mesh: Mesh, camera: Camera, binning, axis: str) -> tuple[Camera, int]:
    """This rank's strip of ``camera`` and the strips' height."""
    if axis != "tiles":
        raise ValueError("strips run over the 'tiles' axis")
    sh = strip_height(camera.height, mesh.tiles, binning.tile if binning else DEFAULT_TILE)
    return strip_camera(camera, sh, mesh.tile_index * sh), sh


def make_tile_sharded_render(mesh: Mesh, camera: Camera, renderer: str = "auto", binning=None,
                             axis: str = "tiles"):
    """``render_strips(args, w2c, K, binning=None)`` -> the (V, C, H_pad, W)
    image on every rank of the axis (the caller crops rows to
    ``camera.height``); the gradients of ``args`` are summed over the
    axis."""
    strip_cam, sh = _strip(mesh, camera, binning, axis)

    def render_strips(args: RenderArgs, w2c, K, binning=binning):
        args, _ = _replicated_args(args, [], mesh, axis)
        cam = dataclasses.replace(strip_cam, w2c=w2c, K=K)
        return gather_rows(pad_rows(render(args, cam, impl=renderer, config=binning).image, sh),
                           mesh)

    return render_strips


def make_tile_sharded_render_dual(mesh: Mesh, camera: Camera, renderer: str = "auto",
                                  binning=None, axis: str = "tiles"):
    """Strip-sharded ``render_dual`` for stage 1's image + segmentation loss:
    each rank bins and composites only its strip, for both composites.

    Returns ``dual_strips(args, colors_b, w2c, K, binning=None)`` -> (image (V, C, H_pad,
    W), segmentation image (V, C_b, H_pad, W), radii (V, N), overflow (V,),
    span_overflow (V,)): the images whole on every rank of the axis, the
    radii and flags maxed over the strips (the EWA radius does not depend
    on the principal point).  The gradients of ``args`` (the
    ``means2d_offset`` collector's too) and of ``colors_b`` are summed over
    the strips: the sum of the strips' screen gradients is the whole
    image's.  A ``binning`` at the call (a grown budget) replaces the
    builder's; the strips stay cut at the builder's tile."""
    strip_cam, sh = _strip(mesh, camera, binning, axis)

    def dual_strips(args: RenderArgs, colors_b, w2c, K, binning=binning):
        args, (colors_b,) = _replicated_args(args, [colors_b], mesh, axis)
        cam = dataclasses.replace(strip_cam, w2c=w2c, K=K)
        out_a, out_b = render_dual(args, colors_b, cam, impl=renderer, config=binning)
        c = out_a.image.shape[1]
        both = gather_rows(pad_rows(torch.cat([out_a.image, out_b.image], dim=1), sh), mesh)
        v = out_a.radii.shape[0]
        flags = torch.cat([out_a.radii.detach().reshape(-1),
                           (out_a.overflowed | out_b.overflowed).float(),
                           (out_a.span_overflowed | out_b.span_overflowed).float()])
        flags = mesh.all_reduce(flags, "max", axis)
        radii = flags[:-2 * v].view_as(out_a.radii)
        return (both[:, :c], both[:, c:], radii, flags[-2 * v:-v] > 0, flags[-v:] > 0)

    return dual_strips


def whole_outputs(image, seg_image, radii, overflow, span, height: int):
    """``dual_strips``' results as two ``RenderOutput``s cropped to
    ``height`` rows (depth, final T, ``last`` and the pair counts stay in
    the strips: None)."""
    out = RenderOutput(image[..., :height, :], None, radii, None, None, overflow, span, None)
    return out, dataclasses.replace(out, image=seg_image[..., :height, :])
