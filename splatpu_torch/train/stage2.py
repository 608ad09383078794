"""Stage-2 pieces the serving path reads (port of
``splatpu/train/stage2.py:53-163, 384-406``): the config fields the rollout
and the render use, ``compact_cloud`` and ``rollout_step``.  The trainer
itself comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from splatpu_torch.core.types import GaussianCloud
from splatpu_torch.dynamics.deform import (
    normalize_and_encode_means_and_rotations,
    update_cloud_parameters,
)
from splatpu_torch.dynamics.network import DeformationNet
from splatpu_torch.render.binning import BinningConfig


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    """The fields of the JAX ``Stage2Config`` that serving reads.  The head
    knobs (``delta_scale``, ``double_residual``, ``zero_init_head``,
    ``time_gate_head``) and widths live in the network's own
    ``DeformationNetConfig``; the port always computes in float32."""

    timestep_count: int = 10
    renderer: str = "auto"
    binning: Optional[BinningConfig] = None
    quirk_compat: bool = True


def compact_cloud(cloud: GaussianCloud) -> GaussianCloud:
    """Exactly the alive rows, all alive.  Not rounded up: BatchNorm takes
    its statistics over every row the network sees, so padding rows would
    change every output."""
    idx = torch.nonzero(cloud.alive, as_tuple=True)[0]
    params = {k: v[idx] for k, v in cloud.param_dict().items()}
    return GaussianCloud(
        alive=torch.ones((idx.numel(),), dtype=torch.bool, device=cloud.alive.device), **params
    )


@torch.no_grad()
def rollout_step(
    net: DeformationNet,
    initial_cloud: GaussianCloud,
    encoded_initial,
    encoded_previous,
    timestep,
    config: Stage2Config,
):
    """One no-grad deformation step: (deformed cloud, its encoding)."""
    updated = update_cloud_parameters(
        net, initial_cloud, encoded_initial, encoded_previous, timestep,
        config.timestep_count, config.quirk_compat,
    )
    enc_prev = normalize_and_encode_means_and_rotations(
        updated.means, updated.rotation_quaternions, quirk_compat=config.quirk_compat
    )
    return updated, enc_prev
