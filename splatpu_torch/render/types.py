"""Render output container (port of ``splatpu/render/types.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RenderOutput:
    """Outputs of a batched render over V views.

    image: (V, C, H, W) composited channels, bg already added.
    depth: (V, H, W) expected view-space depth (sum of w_i * z_i).
    radii: (V, N) float screen radii; 0 => culled in that view.
    final_transmittance: (V, H, W) residual T after compositing.
    last_contributor: (V, H, W) int32 position, in the view's sorted pair
        stream, of the last pair that contributed to the pixel (-1: none).
    overflowed: (V,) bool — a binning budget was exceeded and splats were
        dropped in that view.
    span_overflowed: (V,) bool — specifically the tile-span budget
        (max_span / big-class capacity); growth must raise that one.
    total_pairs: (V,) int32 pairs demanded before budget clipping.
    """

    image: torch.Tensor
    depth: torch.Tensor
    radii: torch.Tensor
    final_transmittance: torch.Tensor
    last_contributor: torch.Tensor
    overflowed: torch.Tensor
    span_overflowed: torch.Tensor
    total_pairs: torch.Tensor
