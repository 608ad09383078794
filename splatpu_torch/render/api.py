"""Public render entry point and binning-budget policy (port of
``splatpu/render/api.py:45-70, 166-270``).

``render(args, camera, bg, impl, config)`` renders every view of a (possibly
batched) camera in one call.  ``impl``:

- ``"cuda"``:  exact binning + the hand-written CUDA composite (CUDA tensors);
- ``"plain"``: exact binning + the composite's plain PyTorch version;
- ``"auto"``:  ``"cuda"`` for CUDA tensors, ``"plain"`` for CPU tensors, as
  the JAX package picks its Pallas kernels on a TPU.
"""

from __future__ import annotations

import dataclasses

import torch

from splatpu_torch.core.projection import preprocess, tile_rect
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.render.binning import DEFAULT_TILE, BinningConfig, tile_grid
from splatpu_torch.render.exact import render_exact
from splatpu_torch.render.types import RenderOutput


def resolve_impl(impl: str, device: torch.device) -> str:
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown renderer impl: {impl!r}")
    return impl


def render(
    args: RenderArgs,
    camera: Camera,
    bg=None,
    impl: str = "auto",
    config: BinningConfig | None = None,
) -> RenderOutput:
    impl = resolve_impl(impl, args.means3d.device)
    if config is None:
        config = default_config(args.n)
    return render_exact(args, camera, bg, config, impl=impl)


def default_config(n_gaussians: int, tile: int = DEFAULT_TILE) -> BinningConfig:
    """32 px tiles with a ~4-pairs-per-Gaussian budget (8 at 16 px tiles),
    rounded up to the chunk size."""
    chunk = 128 if tile <= 16 else 256
    cfg = BinningConfig(tile=tile, chunk_pairs=chunk)
    per_gaussian = 8 if tile <= 16 else 4
    budget = min(max(n_gaussians * per_gaussian, 1 << 12), 1 << 21)
    budget = -(-budget // chunk) * chunk
    return dataclasses.replace(cfg, max_pairs=budget)


def measure_binning_demand(
    args: RenderArgs, cameras: Camera, tile: int = DEFAULT_TILE
) -> tuple[int, int]:
    """(max total pairs, max tiles covered by one Gaussian) over the views of
    ``cameras``: pre-cull upper bounds from one preprocess per view."""
    tiles_x, tiles_y = tile_grid(cameras.width, cameras.height, tile)
    totals, spans = [], []
    for i in range(cameras.num_views):
        sp = preprocess(args, cameras.view(i))
        tx0, ty0, tx1, ty1 = tile_rect(sp.mean2d, sp.radius, tiles_x, tiles_y, tile)
        count = torch.where(sp.visible, (tx1 - tx0) * (ty1 - ty0), torch.zeros_like(tx0))
        totals.append(count.sum())
        spans.append(count.max() if count.numel() else count.new_zeros(()))
    return int(torch.stack(totals).max()), int(torch.stack(spans).max())


def demand_binning(
    demand_pairs: int,
    demand_span: int,
    tile: int = DEFAULT_TILE,
    headroom: float = 2.0,
    overrides: dict | None = None,
    span_cap: int = 512,
) -> BinningConfig:
    """Budget sized from measured demand with headroom; span rounded to the
    next power of two above 2x demand, floored at the default and capped."""
    ov = dict(overrides or {})
    tile = ov.pop("tile", tile)
    base = default_config(1, tile=tile)
    chunk = base.chunk_pairs
    budget = max(int(demand_pairs * headroom), 1 << 12)
    budget = min(budget, 1 << 24)
    budget = -(-budget // chunk) * chunk
    budget = min(budget, 1 << 24)
    span = max(int(demand_span * 2), base.max_span)
    span = 1 << (span - 1).bit_length()
    span = max(base.max_span, min(span, 1 << (max(span_cap, 1) - 1).bit_length()))
    cfg = dataclasses.replace(base, max_pairs=budget, max_span=span)
    return dataclasses.replace(cfg, **ov)
