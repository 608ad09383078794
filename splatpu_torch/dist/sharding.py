"""Camera-sharded and (cameras x tiles)-sharded stage-2 image losses (port
of ``splatpu/dist/sharding.py``).

The sampled views are the data axis: padded to a multiple of the
``cameras`` axis (padding views weigh 0), each camera rank renders its
contiguous block of them (JAX's ``P("cameras")``), and the loss sums are
all-reduced.  JAX's ``psum`` inside ``shard_map`` gives every device the
sum and, under ``grad``, each device's own share of the gradient; here
``reduced`` does the same: the value is the sum over the ranks, the
gradient flows to this rank's own terms only.  The trainer then sums the
network's gradients over every rank (``dist/train_step.py``).

In the 2D step each (camera, tile) rank renders one strip of each of its
views (``dist/tile_sharding.py``); the strips are gathered over the tiles
axis into whole images on every tile rank, and the loss is taken there,
since SSIM's window crosses the seams.  The gather's backward takes this
rank's own rows of the whole-image cotangent, which is the same on every
tile rank of a camera block.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from splatpu_torch.core.ssim import ssim
from splatpu_torch.core.types import Camera
from splatpu_torch.dist.mesh import Mesh
from splatpu_torch.render.api import render
from splatpu_torch.render.binning import DEFAULT_TILE
from splatpu_torch.train.stage2 import view_losses


def pad_views(w2c, K, images, axis_size: int):
    """The view batch padded to a multiple of ``axis_size`` by repeating
    view 0; returns the tensors and a (V,) float32 weight vector (1 real,
    0 padding)."""
    v = w2c.shape[0]
    pad = (-v) % axis_size
    weights = torch.cat([torch.ones(v), torch.zeros(pad)]).to(w2c.device)
    if pad:
        rep = lambda a: torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])  # noqa: E731
        w2c, K, images = rep(w2c), rep(K), rep(images)
    return w2c, K, images, weights


def pad_picks(pick, axis_size: int):
    """A (V,) view-index vector padded to a multiple of ``axis_size`` with
    index 0; returns (padded pick, (V,) float32 weights, 1 real, 0 padding)."""
    v = pick.shape[0]
    pad = (-v) % axis_size
    weights = torch.cat([torch.ones(v), torch.zeros(pad)]).to(pick.device)
    if pad:
        pick = torch.cat([pick, torch.zeros((pad,), dtype=pick.dtype, device=pick.device)])
    return pick, weights


def camera_block(n_views: int, mesh: Mesh) -> slice:
    """This camera rank's contiguous block of ``n_views`` padded views."""
    if n_views % mesh.cameras:
        raise ValueError(f"{n_views} views do not divide the {mesh.cameras} camera ranks")
    b = n_views // mesh.cameras
    return slice(mesh.camera_index * b, (mesh.camera_index + 1) * b)


def reduced(local: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``local`` over ``axis``, differentiable in this rank's
    own ``local`` only (``psum`` under ``shard_map``)."""
    total = mesh.all_reduce(local.detach().clone(), "sum", axis)
    return total + (local - local.detach())


def _reduce(mesh: Mesh, l1, s, overflow, span, pairs):
    """The loss sums over the camera ranks (differentiable in this rank's
    own, one collective); the overflow flags and the pair demand maxed over
    every rank (one collective; float64 holds any pair count exactly)."""
    sums = reduced(torch.stack([l1, s]), mesh, "cameras")
    f = mesh.all_reduce(torch.stack([overflow.double(), span.double(), pairs.double()]), "max",
                        "world")
    return sums[0], sums[1], f[0].float(), f[1].float(), f[2].long()


def make_camera_sharded_image_losses(mesh: Mesh, camera_static: Camera, renderer: str,
                                     binning, view_batching: str = "map"):
    """``image_losses(args, w2c, K, images, weights, binning=None)`` ->
    (l1_sum, ssim_sum, overflow_max, span_overflow_max, pairs) over the
    padded views sharded over the ``cameras`` axis: every rank gets the sums
    over all the views and the flags' max; gradients flow to this rank's
    views only.  ``binning`` at the call (a grown budget) replaces the
    builder's.  ``view_batching``: "map" (one render per view, as JAX's
    ``lax.map``) or "vmap" (the rank's views in one batched render)."""

    def image_losses(args, w2c, K, images, weights, binning=binning):
        sl = camera_block(w2c.shape[0], mesh)
        l1, s, overflow, span, pairs = view_losses(
            args, camera_static, w2c[sl], K[sl], images[sl], weights[sl], renderer, binning,
            view_batching)
        return _reduce(mesh, l1, s, overflow, span, pairs)

    return image_losses


def make_2d_sharded_image_losses(mesh: Mesh, camera_static: Camera, renderer: str, binning,
                                 view_batching: str = "map"):
    """The 2D stage-2 image losses: views over the ``cameras`` axis x image
    strips over ``tiles``, in one step.  Same contract as
    ``make_camera_sharded_image_losses``; ``pairs`` is the largest strip's
    demand.  Each rank renders its strip of each of its camera block's
    views, the strips are gathered into whole images on every tile rank
    (``tile_sharding.gather_rows``), and the losses of the block are taken
    there and summed over the camera ranks.  The strip height follows the
    builder's tile; a budget given at the call keeps that tile."""
    from splatpu_torch.dist.tile_sharding import gather_rows, pad_rows, strip_camera, strip_height

    tile_px = binning.tile if binning is not None else DEFAULT_TILE
    sh = strip_height(camera_static.height, mesh.tiles, tile_px)
    strip_cam = strip_camera(camera_static, sh, mesh.tile_index * sh)
    h = camera_static.height

    def image_losses(args, w2c, K, images, weights, binning=binning):
        sl = camera_block(w2c.shape[0], mesh)
        if binning is not None and binning.tile != tile_px:
            raise ValueError(f"the strips are cut at {tile_px} px tiles, not {binning.tile}")
        w2c, K, images, weights = w2c[sl], K[sl], images[sl], weights[sl]
        groups = ([slice(None)] if view_batching == "vmap"
                  else [slice(i, i + 1) for i in range(w2c.shape[0])])
        strips, outs = [], []
        for g in groups:
            with record_function("render"):
                cams = dataclasses.replace(strip_cam, w2c=w2c[g], K=K[g])
                out = render(args, cams, impl=renderer, config=binning)
            strips.append(pad_rows(out.image, sh))
            outs.append(out)
        with record_function("loss"):
            imgs = gather_rows(torch.cat(strips), mesh)[:, :, :h]
            l1 = (imgs - images).abs().mean(dim=(1, 2, 3)) * weights
            s = (1.0 - ssim(imgs, images, size_average=False)) * weights
        overflow = (torch.cat([o.overflowed for o in outs]) & (weights > 0)).any().float()
        span = (torch.cat([o.span_overflowed for o in outs]) & (weights > 0)).any().float()
        pairs = torch.cat([o.total_pairs for o in outs]).max()
        return _reduce(mesh, l1.sum(), s.sum(), overflow, span, pairs)

    return image_losses

