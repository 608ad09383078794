"""Multi-sequence batch training command line (port of
``splatpu/cli/train_batch.py``; BASELINE config 5's orchestration).

    python -m splatpu_torch.cli.train_batch <data-directory-path>
        <total-iteration-count> <warmup-iteration-count> <learning-rate>
        <hidden-dimension> <residual-block-count>
        --sequences juggle basketball softball [-t N] [-o PATH]
        [--coordinator host:port --process-id K --num-processes P]
        [--device cuda|cpu]

The JAX package's positionals, flags and defaults, plus ``--device``.  The
sequences are assigned in contiguous blocks to the processes
(``dist.multiseq``); each trains through ``stage2.train`` exactly as an
independent ``cli.train`` run of it would (its network bitwise equal).

- ``--coordinator`` given: this process is process ``--process-id`` of
  ``--num-processes``, met over TCP at the coordinator.
- ``--num-processes P`` > 1 without a coordinator: the P processes are
  started on this host (``dist.launch``).
- ``--mesh-cameras C`` shards each sequence's sampled views over C ranks,
  started on this host, which train every sequence together (the JAX
  package shards them over one process's local devices).  Refused with
  more than one process, where the JAX package has no working
  counterpart: its ``train`` builds the mesh over every process's devices
  (``splatpu/dist/mesh.py:41-57``, ``splatpu/train/stage2.py:469-478``)
  while each process trains its own sequences
  (``splatpu/dist/multiseq.py:105``), so the mesh raises or one step mixes
  sequences.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from splatpu_torch.cli.densify import add_binning_flags, binning_from_args
from splatpu_torch.dist.launch import main_on_ranks
from splatpu_torch.dist.mesh import initialize_multihost, rank_device, world
from splatpu_torch.train.stage2 import Stage2Config


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="splatpu-torch-train-batch")
    p.add_argument("data_directory_path", type=Path)
    p.add_argument("total_iteration_count", type=int)
    p.add_argument("warmup_iteration_count", type=int)
    p.add_argument("learning_rate", type=float)
    p.add_argument("hidden_dimension", type=int)
    p.add_argument("residual_block_count", type=int)
    p.add_argument("--sequences", nargs="+", required=True,
                   help="sequence names under data_directory_path")
    p.add_argument("-t", "--timestep-count-limit", type=int, default=None)
    p.add_argument("-o", "--output-directory-path", type=Path, default=Path("./out"))
    p.add_argument("--renderer", default="auto")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--view-staging", default="device", choices=["device", "device_u8", "host"])
    p.add_argument("--mesh-cameras", type=int, default=0,
                   help="per-sequence camera sharding over ranks on this host (one process)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume each local sequence from its checkpoint in the output"
                        " directory when present")
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    add_binning_flags(p)
    p.add_argument("--device", default="cuda", help="torch device (cuda, or cpu for tests)")
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = parser()
    args = p.parse_args(argv)
    processes = args.num_processes or 1
    if args.mesh_cameras > 0 and processes > 1:
        p.error("--mesh-cameras shards one process's sequences over ranks on its host; it"
                " cannot be combined with --num-processes above 1")
    if args.coordinator is not None and world()[1] == 1:
        initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                             device=args.device)
        if processes > 1 and rank_device(args.device).type == "cuda":
            from splatpu_torch import _build

            _build.load_library()  # one build per host before any rank renders
    elif world()[1] == 1:
        ranks = args.mesh_cameras if args.mesh_cameras > 0 else processes
        if ranks > 1:
            return main_on_ranks(main, argv, ranks, args.device)

    from splatpu_torch.data.dataset import load_metadata, load_timestep_views
    from splatpu_torch.dist.multiseq import SequenceJob, train_sequences
    from splatpu_torch.dist.process import ProcessTopology
    from splatpu_torch.io.checkpoint import load_cloud

    device = rank_device(args.device)

    def make_job(name: str) -> SequenceJob:
        sequence_path = args.data_directory_path / name
        metadata = load_metadata(sequence_path)
        t_count = metadata.timestep_count
        if args.timestep_count_limit is not None:
            t_count = min(t_count, args.timestep_count_limit)
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
            mesh_cameras=args.mesh_cameras,
            checkpoint_every=args.checkpoint_every,
        )
        return SequenceJob(
            name=name,
            # Lazy: a sequence of another process costs no IO here.
            initial_cloud=lambda sp=sequence_path: load_cloud(
                sp / "densified_initial_gaussian_cloud_parameters.npz", device=device),
            views_by_timestep=lambda sp=sequence_path, md=metadata, tc=t_count: [
                load_timestep_views(md, t, sp) for t in range(1, tc + 1)],
            config=config,
        )

    jobs = [make_job(n) for n in args.sequences]
    # Under --mesh-cameras the ranks are one process's devices: every rank
    # trains every sequence, and rank 0 writes.
    sharded = args.mesh_cameras > 0
    topo = ProcessTopology() if sharded else ProcessTopology.current()
    results = train_sequences(jobs, topo=topo, out_dir=args.output_directory_path,
                              progress=True, resume=args.resume, device=device,
                              writes=not sharded or world()[0] == 0)
    print(f"trained {len(results)}/{len(jobs)} sequences in this process: {sorted(results)}")


if __name__ == "__main__":
    main()
