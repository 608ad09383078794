"""Naive O(N * pixels) differentiable renderer, the port's in-package ground
truth (port of ``splatpu/render/oracle.py``).

Every Gaussian is evaluated at every pixel, sorted globally by view-space
depth and composited front to back with the serial termination rule (a
Gaussian that would drop T below 1e-4 is dropped, and everything behind it).
Gaussians composite only into the 16 px tiles their 3-sigma rectangle
covers, as the tiled renderers do.  Gradients come from autograd.  Memory is
O(N * H * W): small scenes and tests only.
"""

from __future__ import annotations

import torch

from splatpu_torch.core.projection import (
    ALPHA_MAX,
    ALPHA_MIN,
    TRANSMITTANCE_EPS,
    preprocess,
    tile_rect,
)
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.render.types import RenderOutput

ORACLE_TILE = 16


def evaluate_alpha(conic_a, conic_b, conic_c, opacity, dx, dy):
    """Alpha at pixel offsets (dx, dy): 0 where power > 0 or alpha < 1/255,
    else min(0.99, opacity * exp(power))."""
    power = -0.5 * (conic_a * dx * dx + conic_c * dy * dy) - conic_b * dx * dy
    alpha = torch.clamp(opacity * torch.exp(power), max=ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def _render_view(args: RenderArgs, camera: Camera, bg: torch.Tensor):
    h, w = camera.height, camera.width
    dev = args.means3d.device
    sp = preprocess(args, camera)
    sort_depth = torch.where(sp.visible, sp.depth, torch.full_like(sp.depth, float("inf")))
    order = torch.argsort(sort_depth.detach(), stable=True)

    mean2d = sp.mean2d[order]
    conic = sp.conic[order]
    depth = sp.depth[order]
    colors = args.colors[order]
    opacity = torch.where(sp.visible, args.opacities[:, 0], torch.zeros_like(sp.depth))[order]

    px = torch.arange(w, dtype=torch.float32, device=dev)
    py = torch.arange(h, dtype=torch.float32, device=dev)
    dx = px[None, None, :] - mean2d[:, 0][:, None, None]          # (N, H, W)
    dy = py[None, :, None] - mean2d[:, 1][:, None, None]
    alpha = evaluate_alpha(
        conic[:, 0][:, None, None], conic[:, 1][:, None, None], conic[:, 2][:, None, None],
        opacity[:, None, None], dx, dy,
    )
    tiles_x, tiles_y = -(-w // ORACLE_TILE), -(-h // ORACLE_TILE)
    tx0, ty0, tx1, ty1 = tile_rect(
        mean2d.detach(), sp.radius[order].detach(), tiles_x, tiles_y, ORACLE_TILE
    )
    ptx = (torch.arange(w, device=dev) // ORACLE_TILE)[None, None, :]
    pty = (torch.arange(h, device=dev) // ORACLE_TILE)[None, :, None]
    in_rect = (
        (ptx >= tx0[:, None, None]) & (ptx < tx1[:, None, None])
        & (pty >= ty0[:, None, None]) & (pty < ty1[:, None, None])
    )
    alpha = torch.where(in_rect, alpha, torch.zeros_like(alpha))

    one_minus = 1.0 - alpha
    t_incl = torch.cumprod(one_minus, dim=0)
    t_excl = torch.cat([torch.ones_like(t_incl[:1]), t_incl[:-1]], dim=0)
    fail = t_excl * one_minus < TRANSMITTANCE_EPS
    contribute = ~(torch.cumsum(fail.to(torch.int32), dim=0) > 0).detach()

    weights = torch.where(contribute, alpha * t_excl, torch.zeros_like(alpha))
    image = torch.einsum("nhw,nc->chw", weights, colors)
    depth_map = torch.einsum("nhw,n->hw", weights, depth)
    t_final = torch.prod(torch.where(contribute, one_minus, torch.ones_like(one_minus)), dim=0)
    image = image + t_final[None] * bg[:, None, None]
    return image, depth_map, t_final, sp.radius


def render_oracle(args: RenderArgs, camera: Camera, bg=None) -> RenderOutput:
    """Render every view of ``camera`` (batched or not) naively.  There is no
    pair stream: ``last_contributor`` is -1, the budget flags are false and
    ``total_pairs`` is 0."""
    c = args.colors.shape[1]
    dev = args.means3d.device
    if bg is None:
        bg = torch.zeros((c,), dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    views = [_render_view(args.for_view(i), camera.view(i), bg)
             for i in range(camera.num_views)]
    image, depth, tfin, radii = (torch.stack(x) for x in zip(*views))
    v = camera.num_views
    none = torch.zeros((v,), dtype=torch.bool, device=dev)
    return RenderOutput(
        image=image,
        depth=depth,
        radii=radii,
        final_transmittance=tfin,
        last_contributor=torch.full(depth.shape, -1, dtype=torch.int32, device=dev),
        overflowed=none,
        span_overflowed=none,
        total_pairs=torch.zeros((v,), dtype=torch.int32, device=dev),
    )
