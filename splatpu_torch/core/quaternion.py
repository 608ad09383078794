"""Quaternion math, (w, x, y, z) order (port of ``splatpu/core/quaternion.py``)."""

import torch


def quat_normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalise along the last axis; ``eps`` floors the norm."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    if eps:
        norm = torch.clamp(norm, min=eps)
    return q / norm


def rotation_entries(q: torch.Tensor, eps: float = 0.0):
    """Normalise, then the nine rotation-matrix entries as a 3x3 nest of
    tensors shaped like ``q[..., 0]``."""
    q = quat_normalize(q, eps=eps)
    r, x, y, z = q.unbind(-1)
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
    ]


def build_rotation(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """(..., 4) quaternions -> (..., 3, 3) rotation matrices."""
    rows = rotation_entries(q, eps=eps)
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
