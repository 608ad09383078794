"""Procedural scenes: random Gaussian clouds and look-at cameras (port of
``splatpu/data/synthetic.py``).

``make_random_cloud`` draws from a threefry key through ``core/prng.py``,
as the JAX package's draws from ``jax.random``: the same key gives the
same cloud (the uniform fields to the bit, the normalised quaternions and
the log scales to float32 rounding), so the acceptance truth and the
bench cloud need no export.
"""

from __future__ import annotations

import numpy as np
import torch

from splatpu_torch.core import prng
from splatpu_torch.core.types import Camera, GaussianCloud, cloud_from_arrays


def make_random_cloud(key, n: int, capacity: int | None = None, center=(0.0, 0.0, 0.0),
                      extent: float = 1.0, scale_range=(0.02, 0.08), fg_fraction: float = 0.7,
                      device="cuda") -> GaussianCloud:
    """A cloud of ``n`` random Gaussians in ``capacity`` rows: ``key``
    split in six, then means uniform in the cube of half side ``extent``
    around ``center``, colours uniform, unit quaternions from normals,
    opacity logits uniform in [-1, 3), the log of scales uniform in
    ``scale_range``, foreground with probability ``fg_fraction``
    (segmentation (fg, 0, bg))."""
    ks = prng.split(key, 6)
    means = prng.uniform(ks[0], (n, 3), -extent, extent, device)
    means = means + torch.tensor(center, dtype=torch.float32, device=device)
    colors = prng.uniform(ks[1], (n, 3), device=device)
    quats = prng.normal(ks[2], (n, 4), device)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacity_logits = prng.uniform(ks[3], (n, 1), -1.0, 3.0, device)
    log_scales = torch.log(prng.uniform(ks[4], (n, 3), scale_range[0], scale_range[1], device))
    fg = (prng.uniform(ks[5], (n,), device=device) < fg_fraction).float()
    seg = torch.stack([fg, torch.zeros_like(fg), 1.0 - fg], dim=-1)
    return cloud_from_arrays(means=means, colors=colors, segmentation_masks=seg,
                             rotation_quaternions=quats, opacity_logits=opacity_logits,
                             log_scales=log_scales, capacity=capacity, device=device)


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
