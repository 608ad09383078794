"""State normalisation / encoding and deformation application (port of
``splatpu/dynamics/deform.py``).

Per-axis min-max normalisation of means and quaternions to [-1, 1], PE10 /
PE4 encodings concatenated to (N, 92); the progress t/T encoded with PE4 and
tiled to N rows; the network delta split 3/4 and added at ``delta_scale``
(times t/T when ``time_gate_head``).
"""

from __future__ import annotations

import torch

from splatpu_torch.core.encoding import positional_encoding
from splatpu_torch.core.types import GaussianCloud
from splatpu_torch.dynamics.network import DeformationNet

MEANS_FREQUENCIES = 10
ROTATION_FREQUENCIES = 4
PROGRESS_FREQUENCIES = 4


def _minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=0)
    shifted = x - lo
    hi = shifted.amax(dim=0)
    return 2.0 * shifted / hi - 1.0


def normalize_and_encode_means_and_rotations(means, rotations, quirk_compat: bool = True):
    enc_means = positional_encoding(_minmax_normalize(means), MEANS_FREQUENCIES, quirk_compat)
    enc_rots = positional_encoding(_minmax_normalize(rotations), ROTATION_FREQUENCIES, quirk_compat)
    return torch.cat([enc_means, enc_rots], dim=1)


def _progress(timestep, timestep_count, device) -> torch.Tensor:
    """t / T as a float32 division of two tensors (a Python divisor may be
    applied as a reciprocal multiply, which rounds differently)."""
    t = torch.tensor(float(timestep), dtype=torch.float32, device=device)
    return t / torch.tensor(float(timestep_count), dtype=torch.float32, device=device)


def encode_progress(timestep, timestep_count, n: int, quirk_compat: bool = True, device="cuda"):
    progress = _progress(timestep, timestep_count, device)
    enc = positional_encoding(progress.reshape(1, 1), PROGRESS_FREQUENCIES, quirk_compat)
    return enc.expand(n, enc.shape[1])


def update_cloud_parameters(
    net: DeformationNet,
    initial_cloud: GaussianCloud,
    encoded_initial,
    encoded_previous,
    timestep,
    timestep_count: int,
    quirk_compat: bool = True,
) -> GaussianCloud:
    """Apply the deformation network for one timestep."""
    dev = initial_cloud.means.device
    n = initial_cloud.capacity
    initial_mr = torch.cat([initial_cloud.means, initial_cloud.rotation_quaternions], dim=1)
    delta = net(
        initial_mr, encoded_initial, encoded_previous,
        encode_progress(timestep, timestep_count, n, quirk_compat, device=dev),
    )
    cfg = net.config
    scale = cfg.delta_scale
    if cfg.time_gate_head:
        scale = scale * _progress(timestep, timestep_count, dev)
    return initial_cloud.replace(
        means=initial_cloud.means + scale * delta[:, :3],
        rotation_quaternions=initial_cloud.rotation_quaternions + scale * delta[:, 3:],
    )
