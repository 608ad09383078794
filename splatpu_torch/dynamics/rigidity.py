"""Local-rigidity regulariser over the foreground k-NN graph (port of
``splatpu/dynamics/rigidity.py``).

- Foreground = segmentation channel 0 > 0.5; the index set is fixed for all
  of stage 2 (the deformation moves only means and quaternions).
- Neighbour graph: exact k = 20 NN over the initial foreground means,
  weights exp(-2000 d^2).
- Each step's "previous" snapshot holds the conjugated normalised foreground
  quaternions and the offsets to the neighbours, detached.
- The loss rotates the current offsets into the previous frame by
  R(q_cur q_prev^-1)^T and compares them with the previous offsets:
  mean(sqrt(sum((x - y)^2) * w + 1e-20)), eps inside the square root.

The JAX package gives the neighbour gather a custom backward (gather +
cumsum + boundary differences) because XLA's scatter-add is slow on a TPU;
autograd through ``x[indices]`` computes the same gradient, so the inverse
routing tables are not carried.
"""

from __future__ import annotations

import dataclasses

import torch

from splatpu_torch.core.quaternion import build_rotation, quat_conjugate, quat_mult, quat_normalize
from splatpu_torch.neighbors.knn import knn

RIGIDITY_WEIGHT_TEMPERATURE = 2000.0
RIGIDITY_K = 20


@dataclasses.dataclass
class NeighborInfo:
    indices: torch.Tensor  # (F, k) int64, into the foreground subset
    weights: torch.Tensor  # (F, k) float32


@dataclasses.dataclass
class ForegroundInfo:
    """Previous-timestep snapshot, detached."""

    inverted_rotations: torch.Tensor    # (F, 4)
    offsets_to_neighbors: torch.Tensor  # (F, k, 3)


def build_neighbor_info(foreground_means: torch.Tensor, k: int = RIGIDITY_K) -> NeighborInfo:
    idx, d2 = knn(foreground_means.detach(), k)
    return NeighborInfo(
        indices=idx.long(), weights=torch.exp(-RIGIDITY_WEIGHT_TEMPERATURE * d2)
    )


def foreground_info(fg_means, fg_rotations_raw, neighbor_indices) -> ForegroundInfo:
    """Snapshot the current foreground state as the next step's previous
    frame."""
    with torch.no_grad():
        rot = quat_normalize(fg_rotations_raw, eps=1e-12)
        offsets = fg_means[neighbor_indices] - fg_means[:, None]
        return ForegroundInfo(inverted_rotations=quat_conjugate(rot), offsets_to_neighbors=offsets)


def weighted_l2_loss_v2(x, y, w):
    return torch.sqrt(((x - y) ** 2).sum(-1) * w + 1e-20).mean()


def rigidity_loss(fg_means, fg_rotations_raw, neighbor_info: NeighborInfo,
                  previous: ForegroundInfo) -> torch.Tensor:
    cur_rot = quat_normalize(fg_rotations_raw, eps=1e-12)
    rel = build_rotation(quat_mult(cur_rot, previous.inverted_rotations), eps=1e-12)
    offsets = fg_means[neighbor_info.indices] - fg_means[:, None]        # (F, k, 3)
    # R^T @ offset per neighbour, as products and sums (no batched matmul,
    # which a card may run in TF32): in_prev[f, k, j] = sum_i R[f, i, j] o[f, k, i].
    in_prev = (rel[:, None, :, :] * offsets[:, :, :, None]).sum(dim=2)
    return weighted_l2_loss_v2(in_prev, previous.offsets_to_neighbors, neighbor_info.weights)
