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


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (w, -x, -y, -z); the inverse of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, batched over leading axes."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return torch.stack([w, x, y, z], dim=-1)
