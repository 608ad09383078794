"""Stage-1 command line: fit and densify the static cloud of timestep 0
(port of ``splatpu/cli/densify.py``).

    python -m splatpu_torch.cli.densify <sequence_path> [--iterations N]
        [--capacity-factor F] [--renderer ...] [--output PATH] [--wandb]
        [--seed N] [--views-per-step N] [--grad-threshold F]
        [--no-grow-budget] [--checkpoint-every N] [--checkpoint-path P]
        [--resume-from P] [--tile N] [--max-pairs N] ... [--device cuda|cpu]

The JAX package's positionals, flags and defaults, plus ``--device``
(default ``cuda``; ``--device cpu --renderer plain`` runs on the CPU).
Writes ``<sequence>/densify_metrics.jsonl`` and the compacted cloud
(``--output``, default
``<sequence>/densified_initial_gaussian_cloud_parameters.npz``), which
``cli.train`` of either package reads.  ``--mesh-tiles N`` renders each
view as N row strips, one per rank: run as a rank of a process group of N
ranks, or alone, and it starts the ranks on this host itself
(``dist.launch``); rank 0 writes the metrics and the cloud.  The JAX
package's compilation cache (``obs/cache.py``) has no counterpart here.

``add_binning_flags`` / ``binning_from_args`` are the binning-budget flags
that ``cli/train.py`` shares.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from splatpu_torch.data.dataset import (
    get_scene_radius,
    load_initial_point_cloud,
    load_metadata,
    load_timestep_views,
)
from splatpu_torch.dist.launch import main_on_ranks
from splatpu_torch.dist.mesh import rank_device, world
from splatpu_torch.growth.densify import DensifyConfig
from splatpu_torch.io.checkpoint import save_cloud
from splatpu_torch.obs.metrics import MetricsLogger
from splatpu_torch.train.stage1 import Stage1Config, fit

BINNING_FLAGS = ("tile", "max_pairs", "max_span", "span_small", "chunk_pairs", "big_capacity")


def add_binning_flags(p: argparse.ArgumentParser) -> None:
    """The binning-budget flags; a flag left out keeps the sized default."""
    g = p.add_argument_group("binning budgets")
    g.add_argument("--tile", type=int, default=None,
                   help="pixels per tile side, a multiple of 8 up to 64")
    g.add_argument("--max-pairs", type=int, default=None,
                   help="total (tile, gaussian) pair budget per render")
    g.add_argument("--max-span", type=int, default=None,
                   help="max tiles a single Gaussian may cover")
    g.add_argument("--span-small", type=int, default=None,
                   help="emission lanes for every Gaussian (two-class split)")
    g.add_argument("--chunk-pairs", type=int, default=None,
                   help="pair-stream chunk size (multiple of 128)")
    g.add_argument("--big-capacity", type=int, default=None,
                   help="static big-Gaussian emission slots")


def binning_from_args(args) -> dict | None:
    """The flags given, as field overrides applied on top of the sized
    budget (a single flag such as --tile keeps the sizing of the others)."""
    overrides = {k: getattr(args, k) for k in BINNING_FLAGS if getattr(args, k) is not None}
    return overrides or None


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="splatpu-torch-densify")
    p.add_argument("sequence_path", type=Path)
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--capacity-factor", type=float, default=4.0)
    p.add_argument("--renderer", default="auto")
    p.add_argument("--output", type=Path, default=None,
                   help="defaults to <sequence>/densified_initial_gaussian_cloud_parameters.npz")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh-tiles", type=int, default=0,
                   help="image strips per render, one per rank (0 = one process)")
    p.add_argument("--views-per-step", type=int, default=1,
                   help="views rendered per iteration in one batched step (densification"
                        " statistics advance as that many reference iterations)")
    p.add_argument("--grad-threshold", type=float, default=None,
                   help="densification screen-gradient threshold (default 2e-4)")
    p.add_argument("--no-grow-budget", action="store_true",
                   help="disable automatic pair-budget growth on binning overflow")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-path", type=Path, default=None)
    p.add_argument("--resume-from", type=Path, default=None)
    add_binning_flags(p)
    p.add_argument("--device", default="cuda", help="torch device (cuda, or cpu for tests)")
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = parser()
    args = p.parse_args(argv)
    if args.mesh_tiles > 0 and args.views_per_step > 1:
        p.error("--views-per-step above 1 cannot be combined with --mesh-tiles (batch the views"
                " or shard one view's tiles)")
    if args.mesh_tiles > 1 and world()[1] == 1:
        return main_on_ranks(main, argv, args.mesh_tiles, args.device)
    first = world()[0] == 0
    metadata = load_metadata(args.sequence_path)
    point_cloud = load_initial_point_cloud(args.sequence_path)
    scene_radius = get_scene_radius(metadata)
    views = load_timestep_views(metadata, 0, args.sequence_path)
    logger = (MetricsLogger(jsonl_path=args.sequence_path / "densify_metrics.jsonl",
                            use_wandb=args.wandb, wandb_project="densify-gaussian-cloud")
              if first else None)
    densify_cfg = DensifyConfig()
    if args.grad_threshold is not None:
        densify_cfg = dataclasses.replace(densify_cfg, grad_threshold=args.grad_threshold)
    config = Stage1Config(
        iterations=args.iterations,
        capacity_factor=args.capacity_factor,
        densify=densify_cfg,
        renderer=args.renderer,
        binning_overrides=binning_from_args(args),
        mesh_tiles=args.mesh_tiles,
        views_per_step=args.views_per_step,
        grow_budget_on_overflow=not args.no_grow_budget,
        seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=str(args.checkpoint_path) if args.checkpoint_path else None,
    )
    cloud, _ = fit(point_cloud, views, scene_radius, config, logger=logger, progress=first,
                   resume_from=str(args.resume_from) if args.resume_from else None,
                   device=rank_device(args.device))
    if not first:
        return
    out = args.output or (args.sequence_path / "densified_initial_gaussian_cloud_parameters.npz")
    save_cloud(out, cloud)
    logger.close()
    print(f"saved densified cloud ({int(cloud.n_alive())} Gaussians) -> {out}")


if __name__ == "__main__":
    main()
