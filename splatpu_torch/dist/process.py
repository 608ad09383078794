"""Which process am I, and the views this process loads (port of
``splatpu/dist/process.py``).

Multi-process runs load data per process: each process reads only the
camera views its ranks consume.  The topology is a plain value, so
one-process tests cover the multi-process code with a made-up topology;
``ProcessTopology.current()`` reads the process group's rank and size.
"""

from __future__ import annotations

import dataclasses

from splatpu_torch.dist.mesh import world


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """Which process am I, out of how many."""

    count: int = 1
    index: int = 0

    def __post_init__(self):
        if not (0 <= self.index < self.count):
            raise ValueError(f"process index {self.index} not in [0, {self.count})")

    @classmethod
    def current(cls) -> "ProcessTopology":
        """This rank of the process group (one process without one)."""
        rank, size = world()
        return cls(count=size, index=rank)


def local_camera_indices(n_cameras: int, topo: ProcessTopology) -> list[int]:
    """Balanced contiguous camera block for this process: contiguous, so
    that a camera batch sharded over the ``cameras`` axis lands on the
    process that loaded it."""
    base = n_cameras // topo.count
    extra = n_cameras % topo.count
    start = topo.index * base + min(topo.index, extra)
    length = base + (1 if topo.index < extra else 0)
    return list(range(start, start + length))


def load_local_timestep_views(metadata, timestep: int, sequence_path,
                              topo: ProcessTopology | None = None):
    """``load_timestep_views`` of this process's cameras only; each view
    keeps its global camera index."""
    from splatpu_torch.data.dataset import load_timestep_views

    topo = topo or ProcessTopology.current()
    local = local_camera_indices(metadata.camera_count, topo)
    return load_timestep_views(metadata, timestep, sequence_path, camera_indices=local)
