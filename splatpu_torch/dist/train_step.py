"""The distributed stage-2 step (port of ``splatpu/dist/train_step.py``).

The same step body as the single-process trainer, literally: both are
``stage2.make_step``, with the image-loss term swapped for a sharded one
and the network's gradients summed over the ranks (``GradSync``).  The
deformation network, the only trainable state, is replicated: every rank
runs it forward, differentiates its own share of the loss (its views, or
its strips of them; the rigidity term on rank 0 only, since it is
replicated and counted once), and the gradients are summed in one
all-reduce of one flat buffer, in the parameters' order, before the norm
and Adam.  So every rank holds bitwise the same parameters after every
step.

Two sharding modes, chosen by the mesh's shape:

- ``tiles`` == 1: the views sharded over ``cameras``
  (``make_camera_sharded_image_losses``);
- ``tiles`` > 1: the 2D step, views over ``cameras`` x image strips over
  ``tiles`` (``make_2d_sharded_image_losses``).
"""

from __future__ import annotations

import torch

from splatpu_torch.dist.mesh import Mesh
from splatpu_torch.dist.sharding import (
    make_2d_sharded_image_losses,
    make_camera_sharded_image_losses,
)
from splatpu_torch.train.stage2 import camera_template, make_step


class GradSync:
    """The network's gradients summed over every rank in one all-reduce."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.owns_rigidity = mesh.rank == 0

    def __call__(self, grads: dict, params: dict) -> dict:
        names = list(params)
        parts = [(grads[k] if grads[k] is not None else torch.zeros_like(params[k])).reshape(-1)
                 for k in names]
        flat = self.mesh.all_reduce(torch.cat(parts), "sum", "world")
        return {k: g.view_as(params[k]) for k, g in zip(names, flat.split([p.numel() for p in parts]))}


def make_sharded_train_step(config, state, mesh: Mesh, width: int, height: int):
    """``stage2.make_step`` with the views (and, on a mesh with more than one
    tile rank, image strips) sharded over ``mesh``.  The step's ``w2c``,
    ``K`` and ``images`` hold the sampled views padded to a multiple of the
    ``cameras`` axis (``sharding.pad_picks``) and ``weights`` marks real
    views 1 and padding 0; each rank renders its own block of them."""
    make = make_2d_sharded_image_losses if mesh.tiles > 1 else make_camera_sharded_image_losses
    sharded = make(mesh, camera_template(width, height), config.renderer, config.binning,
                   config.view_batching)

    return make_step(config, state, width, height, image_losses=sharded,
                     grad_sync=GradSync(mesh))
