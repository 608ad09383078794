"""Public render entry point and binning-budget policy (port of
``splatpu/render/api.py:45-70, 166-270``).

``render(args, camera, bg, impl, config)`` renders every view of a (possibly
batched) camera in one call.  ``impl``:

- ``"cuda"``:  every view projected and packed by one kernel launch
  (``render/project.py``), exact binning + the hand-written CUDA composite
  (CUDA tensors): K1/K2, or K4 under ``config.kernel="manual"`` (the JAX
  package's ``impl="pallas"``);
- ``"plain"``: exact binning + the same composite's plain PyTorch version;
- ``"cuda_padded"``: the padded pair stream + K5 (the JAX package's
  ``impl="pallas_padded"``), 16 px tiles only;
- ``"plain_padded"``: the padded pair stream + K5's plain versions;
- ``"stream"``: the padded pair stream + the pair-parallel PyTorch
  compositor (``render/stream.py``), on any device, as the JAX package's
  ``impl="stream"``;
- ``"oracle"``: the naive per-pixel renderer (``render/oracle.py``), the
  port's ground truth for small scenes;
- ``"auto"``:  ``"cuda"`` for CUDA tensors, ``"plain"`` for CPU tensors, as
  the JAX package picks its Pallas kernels on a TPU;
- ``"pallas"`` / ``"pallas_padded"``: the JAX package's names of the exact
  and padded paths, taken as ``"cuda"`` / ``"cuda_padded"`` for CUDA
  tensors and as their plain versions for CPU tensors (the counterpart of
  JAX's interpret mode).

With ``config=None`` the budget is ``default_config``'s, at 16 px tiles for
the padded impls and 32 px otherwise, as in the JAX package.  Every impl is
differentiable in the per-Gaussian inputs and ``bg``.

``render_dual(args, colors_b, camera, bg, impl, config)`` is stage 1's
render: one preprocess and binning per view, two composites (the image
from ``args.colors``, the segmentation from ``colors_b``), and the
``means2d_offset`` collector's gradient from the first composite only.
Under ``impl="cuda"`` one kernel launch projects every view and packs
both tables (``render/project.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from splatpu_torch.core.projection import offset_pixel_scale, preprocess, tile_rect
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.render.binning import DEFAULT_TILE, BinningConfig, pair_streams, tile_grid
from splatpu_torch.render.exact import (
    background,
    bin_projected,
    bin_views,
    check_kernel_limits,
    composite_streams,
    render_exact,
)
from splatpu_torch.render.oracle import render_oracle
from splatpu_torch.render.padded import composite_stream, render_padded
from splatpu_torch.render.project import project_views
from splatpu_torch.render.stream import composite_pairs, render_stream, stream_output
from splatpu_torch.render.types import RenderOutput

IMPLS = ("cuda", "plain", "cuda_padded", "plain_padded", "stream", "oracle")
PADDED_IMPLS = {"cuda_padded": "cuda", "plain_padded": "plain"}
# The JAX package's names: (on a card, on the CPU).
JAX_IMPLS = {"auto": ("cuda", "plain"), "pallas": ("cuda", "plain"),
             "pallas_padded": ("cuda_padded", "plain_padded")}


def resolve_impl(impl: str, device: torch.device) -> str:
    if impl in JAX_IMPLS:
        return JAX_IMPLS[impl][0 if device.type == "cuda" else 1]
    if impl not in IMPLS:
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
    if impl == "oracle":
        return render_oracle(args, camera, bg)
    if config is None:
        # The first-generation padded path is fixed at 16x16 tiles.
        config = default_config(args.n, tile=16 if impl in PADDED_IMPLS else DEFAULT_TILE)
    if impl in PADDED_IMPLS:
        return render_padded(args, camera, bg, config, impl=PADDED_IMPLS[impl])
    if impl == "stream":
        return render_stream(args, camera, bg, config)
    return render_exact(args, camera, bg, config, impl=impl)


def render_dual(
    args: RenderArgs,
    colors_b: torch.Tensor,
    camera: Camera,
    bg=None,
    impl: str = "auto",
    config: BinningConfig | None = None,
) -> tuple[RenderOutput, RenderOutput]:
    """Two composites over one shared preprocess and binning per view
    (``splatpu/render/api.py:73-163``): the primary with ``args.colors``,
    the secondary with ``colors_b`` (N, C_b), e.g. the segmentation masks.

    The gradient contract is the reference's: ``args.means2d_offset``
    takes its cotangent from the primary render only; every other input
    takes gradients from both.  The secondary's pixel positions are
    ``mean2d + (off.detach() - off) * wh``: the same values bit for bit,
    with the offset's lineage cancelled.  ``bg`` (default zeros) serves
    both, so ``colors_b`` has the primary's channel count when it is given.
    Under ``impl="cuda"`` the views are projected and both tables packed by
    one ``project_views`` node (a ``record_function`` range ``preprocess``),
    whose backward keeps the same contract; every other impl preprocesses
    each view and cuts the lineage here.
    """
    impl = resolve_impl(impl, args.means3d.device)
    if impl == "oracle":
        off = args.means2d_offset
        seg_args = dataclasses.replace(
            args, colors=colors_b, means2d_offset=None if off is None else off.detach())
        return render_oracle(args, camera, bg), render_oracle(seg_args, camera, bg)
    if config is None:
        config = default_config(args.n, tile=16 if impl in PADDED_IMPLS else DEFAULT_TILE)
    dev = args.means3d.device
    bg = background(bg, args.colors.shape[1], dev)
    off = args.means2d_offset
    wh = offset_pixel_scale(camera)

    def lineage_cut(i, mean2d):
        """View i's secondary pixel positions."""
        if off is None:
            return mean2d
        o = off if off.dim() == 2 else off[i]
        return mean2d + (o.detach() - o) * wh

    if impl in ("cuda", "plain"):
        check_kernel_limits(config, args.colors.shape[1])
        if impl == "cuda":
            with record_function("preprocess"):
                table, radius, visible, table_b = project_views(args, camera, colors_b=colors_b)
            streams = bin_projected(args, camera, config, table, radius, visible)
            packed = dict(table=table), dict(table=table_b)
        else:
            streams = bin_views(args, camera, config)
            packed = {}, dict(mean2d=[lineage_cut(i, s.splats.mean2d)
                                      for i, s in enumerate(streams)])
        return (
            composite_streams(streams, camera, config, bg, args.colors, impl=impl, **packed[0]),
            composite_streams(streams, camera, config, bg, colors_b, impl=impl, **packed[1]),
        )
    streams = pair_streams(args, camera, config)
    mean2d_b = [lineage_cut(i, s.splats.mean2d) for i, s in enumerate(streams)]
    if impl == "stream":
        def composite(colors, mean2d):
            return stream_output(streams, [
                composite_pairs(s, camera.view(i), config, bg, g_colors=colors,
                                g_mean2d=None if mean2d is None else mean2d[i])
                for i, s in enumerate(streams)
            ])

        return composite(args.colors, None), composite(colors_b, mean2d_b)
    padded = PADDED_IMPLS[impl]
    return (
        composite_stream(streams, camera, config, bg, impl=padded),
        composite_stream(streams, camera, config, bg, impl=padded, g_colors=colors_b,
                         g_mean2d=mean2d_b),
    )


def resolve_binning(n_gaussians: int, config: BinningConfig | None = None,
                    overrides: dict | None = None) -> BinningConfig:
    """An explicit ``config`` wins; otherwise ``default_config(n)`` at the
    overrides' tile (32 px without one) with the other overrides applied on
    top, so that one flag such as --tile keeps the sizing of the others
    (``splatpu/render/api.py:182-195``)."""
    if config is not None:
        return config
    ov = dict(overrides or {})
    tile = ov.pop("tile", DEFAULT_TILE)
    return dataclasses.replace(default_config(n_gaussians, tile=tile), **ov)


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
        sp = preprocess(args.for_view(i), cameras.view(i))
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
