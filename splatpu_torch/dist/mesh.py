"""Process groups and the (cameras, tiles) rank grid (port of
``splatpu/dist/mesh.py``).

The JAX package runs one controller over a device mesh.  PyTorch runs one
process per device: each rank of a ``torch.distributed`` process group is
one cell of the grid, and the grid's axes are process groups.

- ``initialize_multihost`` starts the process group from a coordinator
  address, as JAX's starts its distributed runtime; it does nothing for one
  process.
- ``get_mesh(camera_axis, tile_axis)`` lays the world's ranks out as a
  (cameras, tiles) grid in row-major order, as JAX's ``reshape`` lays out
  the devices: rank r sits at ``(r // tiles, r % tiles)``.  Without a
  process group it is the one-cell grid, whose collectives do nothing.

Backends: NCCL when each rank has a card of its own; gloo when ranks share
a card (NCCL refuses two ranks on one device: "Duplicate GPU detected") and
on the CPU.  gloo takes CUDA tensors in every collective used here
(all_reduce SUM and MAX, all_gather_into_tensor, barrier, over subgroups
too; probed with 2 and 4 ranks on one H100 under torch 2.11); it copies
them through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)  # a collective that waits longer raises


def default_backend(device, ranks_here: int) -> str:
    """NCCL when every rank on this host has a card of its own, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and ranks_here <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
):
    """Start the process group over ``tcp://<coordinator_address>``.

    Does nothing for a single process (tests, one card, the CPU).  The
    backend is ``default_backend(device, LOCAL_WORLD_SIZE)`` (one rank on
    this host when the variable is unset)."""
    if num_processes is None or num_processes <= 1:
        return
    backend = default_backend(device, int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=TIMEOUT,
    )


def world() -> tuple[int, int]:
    """(this rank, the world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """This rank's index on its host (``LOCAL_RANK``, else the global rank)."""
    return int(os.environ.get("LOCAL_RANK", world()[0]))


def rank_device(device) -> torch.device:
    """The device this rank computes on: ``cuda:{local_rank % cards}`` for
    a CUDA device without an index, ``device`` itself otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (cameras, tiles) grid and the grid's groups:
    ``groups[axis]`` holds the ranks that differ only along ``axis`` (the
    tiles group of a rank is its row), ``groups["world"]`` every rank; a
    group of one rank is None, and collectives over it do nothing."""

    cameras: int
    tiles: int
    rank: int
    groups: dict

    @property
    def shape(self) -> dict:
        return {"cameras": self.cameras, "tiles": self.tiles}

    @property
    def camera_index(self) -> int:
        return self.rank // self.tiles

    @property
    def tile_index(self) -> int:
        return self.rank % self.tiles

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis: str = "world") -> torch.Tensor:
        """``t`` reduced in place over ``axis`` ("sum" or "max"); returns it."""
        group = self.groups[axis]
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                            group=group)
        return t

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The (axis size, *x.shape) stack of every rank's ``x`` along ``axis``."""
        group = self.groups[axis]
        if group is None:
            return x[None]
        n = self.shape[axis]
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))  # concatenated along dim 0
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out.view((n,) + tuple(x.shape))


_GROUPS: dict = {}


def get_mesh(camera_axis: Optional[int] = None, tile_axis: int = 1) -> Mesh:
    """The (cameras, tiles) grid over every rank of the process group.

    Every rank must call it, in the same order as the others: it creates
    the axes' groups collectively on first use (cached per shape)."""
    rank, n = world()
    if camera_axis is None:
        camera_axis = n // tile_axis
    if camera_axis * tile_axis != n:
        raise ValueError(f"mesh {camera_axis}x{tile_axis} != {n} ranks")
    if n == 1:
        return Mesh(camera_axis, tile_axis, 0, {"cameras": None, "tiles": None, "world": None})
    key = (id(dist.group.WORLD), camera_axis, tile_axis)
    if key not in _GROUPS:
        grid = [[c * tile_axis + t for t in range(tile_axis)] for c in range(camera_axis)]
        groups = {"world": dist.group.WORLD, "cameras": None, "tiles": None}
        # new_group is collective: every rank creates every group, in one order.
        rows = [dist.new_group(row) if tile_axis > 1 else None for row in grid]
        cols = [dist.new_group([row[t] for row in grid]) if camera_axis > 1 else None
                for t in range(tile_axis)]
        groups["tiles"] = rows[rank // tile_axis]
        groups["cameras"] = cols[rank % tile_axis]
        _GROUPS[key] = groups
    return Mesh(camera_axis, tile_axis, rank, _GROUPS[key])
