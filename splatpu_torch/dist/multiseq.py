"""Multi-sequence batch training (port of ``splatpu/dist/multiseq.py``;
BASELINE config 5: several sequences over the processes of a run).

- Assignment: contiguous balanced blocks of sequences per process
  (``job_assignments``), the layout of ``local_camera_indices``.
- Invocation: each assigned sequence trains through the standard
  ``stage2.train``; the orchestration is a pure router, so a sequence's
  result is bitwise the result of an independent run of it.
- Artifacts: per-sequence metrics, checkpoint and ``result.json`` under
  ``out_dir/<sequence>/``.

Sequences of other processes are never touched: a job carries
zero-argument loaders, called for local jobs only.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Optional, Union

from splatpu_torch.dist.process import ProcessTopology
from splatpu_torch.train.stage2 import Stage2Config, train


@dataclasses.dataclass(frozen=True)
class SequenceJob:
    """One sequence's training inputs; ``initial_cloud`` and
    ``views_by_timestep`` may be the values or zero-argument callables (a
    non-local job then costs no IO)."""

    name: str
    initial_cloud: Union[object, Callable[[], object]]
    views_by_timestep: Union[list, Callable[[], list]]
    config: Stage2Config

    def resolve_cloud(self):
        c = self.initial_cloud
        return c() if callable(c) else c

    def resolve_views(self):
        v = self.views_by_timestep
        return v() if callable(v) else v


def job_assignments(n_jobs: int, n_processes: int) -> list[list[int]]:
    """Balanced contiguous job blocks, one list per process."""
    base = n_jobs // n_processes
    extra = n_jobs % n_processes
    out = []
    start = 0
    for p in range(n_processes):
        length = base + (1 if p < extra else 0)
        out.append(list(range(start, start + length)))
        start += length
    return out


def local_jobs(n_jobs: int, topo: Optional[ProcessTopology] = None) -> list[int]:
    topo = topo or ProcessTopology.current()
    return job_assignments(n_jobs, topo.count)[topo.index]


def train_sequences(jobs: list, topo: Optional[ProcessTopology] = None,
                    out_dir: Optional[Union[str, Path]] = None, progress: bool = False,
                    resume: bool = False, device="cuda", writes: bool = True) -> dict:
    """Train this process's sequences; returns ``{name: (net, cloud,
    encoded_initial, last_metrics)}`` for the local jobs only.

    With ``out_dir`` (and ``writes``: false on the ranks of a sharded job
    other than its first) each sequence writes ``<out_dir>/<name>/``
    ``train_metrics.jsonl``, ``stage2_ckpt.msgpack`` (when the job's config
    checkpoints and names no path) and ``result.json``; ``resume`` restarts
    each local job from its own checkpoint where one exists."""
    from splatpu_torch.obs.metrics import MetricsLogger

    topo = topo or ProcessTopology.current()
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate sequence names: {names}")
    results = {}
    for ji in local_jobs(len(jobs), topo):
        job = jobs[ji]
        t0 = time.time()
        logger = run_dir = resume_from = None
        config = job.config
        if out_dir is not None:
            run_dir = Path(out_dir) / job.name
            if writes:
                run_dir.mkdir(parents=True, exist_ok=True)
                logger = MetricsLogger(jsonl_path=run_dir / "train_metrics.jsonl")
            if config.checkpoint_every and not config.checkpoint_path:
                config = dataclasses.replace(
                    config, checkpoint_path=str(run_dir / "stage2_ckpt.msgpack"))
            if resume and config.checkpoint_path and Path(config.checkpoint_path).exists():
                resume_from = config.checkpoint_path
        out = train(job.resolve_cloud(), job.resolve_views(), config, logger=logger,
                    device=device, progress=progress, resume_from=resume_from)
        results[job.name] = out
        if run_dir is not None and writes:
            metrics = out[3] or {}
            (run_dir / "result.json").write_text(json.dumps({
                "sequence": job.name,
                "process": topo.index,
                "process_count": topo.count,
                "sequence_iterations": config.total_iterations,
                "timesteps": config.timestep_count,
                "last_step": {k: float(v) for k, v in metrics.items()
                              if getattr(v, "ndim", 0) == 0},
                "wall_seconds": time.time() - t0,
                "completed": True,
            }, indent=2))
        if logger is not None:
            logger.close()
    return results
