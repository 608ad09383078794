"""Stage-2 command line: train the deformation network on a sequence, then
render the orbit views and export the bundle (port of
``splatpu/cli/train.py``).

    python -m splatpu_torch.cli.train <sequence-name> <data-directory-path>
        <total-iteration-count> <warmup-iteration-count> <learning-rate>
        <hidden-dimension> <residual-block-count>
        [-t N] [-fps N] [-o PATH] [--renderer ...] [--device cuda|cpu] ...

The JAX package's positionals, flags and defaults, plus ``--device``
(default ``cuda``; ``--device cpu --renderer plain`` runs on the CPU).
Writes under ``<output>/<sequence-name>/``: ``train_metrics.jsonl``,
``visualizations/`` (frames, videos), ``config.json`` and the bundle
``deformation_network/``, whose ``config.json`` also records the head
settings (the JAX package's records only the sizes and timestep count).

``--mesh-cameras C`` (with ``--mesh-tiles T``) trains on a C x T grid of
ranks: run as a rank of a process group of C x T ranks, or alone, and it
starts the ranks on this host itself (``dist.launch``; gloo when they share
a card).  Rank 0 writes every artifact.  Without ``--mesh-cameras``,
``--mesh-tiles`` is ignored and one process trains, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from splatpu_torch.cli.densify import add_binning_flags, binning_from_args
from splatpu_torch.data.dataset import load_metadata, load_timestep_views
from splatpu_torch.dist.launch import main_on_ranks
from splatpu_torch.dist.mesh import rank_device, world
from splatpu_torch.io.checkpoint import HEAD_KNOBS, export_deformation_bundle, load_cloud
from splatpu_torch.obs.metrics import MetricsLogger
from splatpu_torch.train.inference import run_inference
from splatpu_torch.train.stage2 import Stage2Config, train

def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="splatpu-torch-train")
    p.add_argument("sequence_name", type=str)
    p.add_argument("data_directory_path", type=Path)
    p.add_argument("total_iteration_count", type=int)
    p.add_argument("warmup_iteration_count", type=int)
    p.add_argument("learning_rate", type=float)
    p.add_argument("hidden_dimension", type=int)
    p.add_argument("residual_block_count", type=int)
    p.add_argument("-t", "--timestep-count-limit", type=int, default=None)
    p.add_argument("-fps", type=int, default=30)
    p.add_argument("-o", "--output-directory-path", type=Path, default=Path("./out"))
    p.add_argument("--renderer", default="auto")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--view-staging", default="device",
                   choices=["device", "device_u8", "host", "device_rotate"],
                   help="where the views live while training: the device as float32 or uint8,"
                        " host memory with each step's views copied one step ahead, or a"
                        " rotating resident camera subset as uint8 on the device")
    p.add_argument("--resident-cameras", type=int, default=8,
                   help="device_rotate: cameras resident at once")
    p.add_argument("--restage-every", type=int, default=10,
                   help="device_rotate: sequence iterations between rotations")
    p.add_argument("--compute-dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="deformation-network matmul dtype; auto = float32 off a TPU")
    p.add_argument("--mesh-cameras", type=int, default=0,
                   help="views sharded over this many camera ranks (0: one process)")
    p.add_argument("--mesh-tiles", type=int, default=1,
                   help="with --mesh-cameras: image strips per view, one per tile rank")
    p.add_argument("--delta-scale", type=float, default=0.01,
                   help="deformation head output scale (reference: 0.01)")
    p.add_argument("--no-double-residual", action="store_true",
                   help="deviation: drop the network-adds-input residual")
    p.add_argument("--zero-init-head", action="store_true",
                   help="deviation: zero-init the head output layer")
    p.add_argument("--time-gate-head", action="store_true",
                   help="deviation: gate the head output by progress t/T")
    p.add_argument("--steps-per-timestep", type=int, default=1,
                   help="Adam steps per visited timestep (reference: 1)")
    p.add_argument("--timestep-order", default="sequential", choices=["sequential", "shuffled"],
                   help="timestep visit order per sequence iteration")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N sequence iterations (0 = off)")
    p.add_argument("--checkpoint-path", type=Path, default=None)
    p.add_argument("--resume-from", type=Path, default=None)
    add_binning_flags(p)
    p.add_argument("--device", default="cuda", help="torch device (cuda, or cpu for tests)")
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = parser()
    args = p.parse_args(argv)
    ranks = args.mesh_cameras * args.mesh_tiles if args.mesh_cameras > 0 else 1
    if ranks > 1 and world()[1] == 1:
        return main_on_ranks(main, argv, ranks, args.device)
    first = world()[0] == 0
    device = rank_device(args.device)
    sequence_path = args.data_directory_path / args.sequence_name
    metadata = load_metadata(sequence_path)
    t_count = metadata.timestep_count
    if args.timestep_count_limit is not None:
        t_count = min(t_count, args.timestep_count_limit)
    cloud = load_cloud(sequence_path / "densified_initial_gaussian_cloud_parameters.npz",
                       device=device)
    views_by_timestep = [
        load_timestep_views(metadata, t, sequence_path) for t in range(1, t_count + 1)
    ]
    config = Stage2Config(
        total_iterations=args.total_iteration_count,
        warmup_iterations=args.warmup_iteration_count,
        learning_rate=args.learning_rate,
        hidden_dim=args.hidden_dimension,
        residual_blocks=args.residual_block_count,
        timestep_count=t_count,
        renderer=args.renderer,
        binning_overrides=binning_from_args(args),
        seed=args.seed,
        view_staging=args.view_staging,
        resident_cameras=args.resident_cameras,
        restage_every=args.restage_every,
        compute_dtype=args.compute_dtype,
        mesh_cameras=args.mesh_cameras,
        mesh_tiles=args.mesh_tiles,
        delta_scale=args.delta_scale,
        double_residual=not args.no_double_residual,
        zero_init_head=args.zero_init_head,
        time_gate_head=args.time_gate_head,
        steps_per_timestep=args.steps_per_timestep,
        timestep_order=args.timestep_order,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=str(args.checkpoint_path) if args.checkpoint_path else None,
    )
    run_dir = args.output_directory_path / args.sequence_name
    logger = None
    if first:
        run_dir.mkdir(parents=True, exist_ok=True)
        logger = MetricsLogger(jsonl_path=run_dir / "train_metrics.jsonl", use_wandb=args.wandb,
                               wandb_project="animating-gaussian-splats")
    net, dense_cloud, encoded_initial, _ = train(
        cloud, views_by_timestep, config, logger=logger, device=device, progress=first,
        resume_from=str(args.resume_from) if args.resume_from else None,
    )
    if not first:
        return
    run_inference(net, dense_cloud, encoded_initial, config, device=device,
                  output_directory=run_dir / "visualizations",
                  views_by_timestep=views_by_timestep, fps=args.fps, logger=logger)
    with (run_dir / "config.json").open("w") as f:
        json.dump({**{k: str(v) if isinstance(v, Path) else v for k, v in vars(args).items()},
                   "timestep_count": t_count}, f, indent="\t")
    export_deformation_bundle(
        run_dir / "deformation_network", net,
        {"timestep_count": t_count, "residual_block_count": args.residual_block_count,
         "hidden_dimension": args.hidden_dimension,
         **{k: getattr(config, k) for k in HEAD_KNOBS}},
        dense_cloud,
    )
    logger.save_run_files(run_dir)
    logger.close()
    print(f"run artifacts -> {run_dir}")


if __name__ == "__main__":
    main()
