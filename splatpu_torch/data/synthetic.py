"""Synthetic cameras (port of ``splatpu/data/synthetic.py:52-85``)."""

from __future__ import annotations

import numpy as np
import torch

from splatpu_torch.core.types import Camera


def lookat_matrices(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                    width: int = 64, height: int = 64, focal: float | None = None):
    """Look-at extrinsics (camera +z toward the target) and a centred pinhole,
    as float32 numpy (w2c (4, 4), K (3, 3))."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    R = np.stack([right, true_up, fwd])
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    if focal is None:
        focal = 0.8 * max(width, height)
    K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]])
    return w2c.astype(np.float32), K.astype(np.float32)


def make_lookat_camera(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                       width: int = 64, height: int = 64, focal: float | None = None,
                       device="cuda") -> Camera:
    w2c, K = lookat_matrices(eye, target, up, width, height, focal)
    return Camera(w2c=torch.from_numpy(w2c).to(device), K=torch.from_numpy(K).to(device),
                  width=width, height=height)
