"""Procedural scenes: random Gaussian clouds and look-at cameras (port of
``splatpu/data/synthetic.py``).

``make_random_cloud`` draws the JAX package's distributions from
``numpy.random.default_rng(seed)``: the numbers differ from the JAX
package's ``jax.random`` draws, so tests that hold the two packages
against each other hand both the same numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from splatpu_torch.core.types import Camera, GaussianCloud, cloud_from_arrays


def random_cloud_arrays(seed: int, n: int, center=(0.0, 0.0, 0.0), extent: float = 1.0,
                        scale_range=(0.02, 0.08), fg_fraction: float = 0.7) -> dict:
    """The raw (N, .) float32 arrays of a random cloud: means uniform in the
    cube of half side ``extent`` around ``center``, colours uniform, unit
    quaternions from normals, opacity logits uniform in [-1, 3], log of
    scales uniform in ``scale_range``, foreground with probability
    ``fg_fraction`` (segmentation (fg, 0, bg))."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3)) + np.asarray(center)
    colors = rng.uniform(0.0, 1.0, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity_logits = rng.uniform(-1.0, 3.0, (n, 1))
    log_scales = np.log(rng.uniform(scale_range[0], scale_range[1], (n, 3)))
    fg = (rng.uniform(size=n) < fg_fraction).astype(np.float64)
    seg = np.stack([fg, np.zeros_like(fg), 1.0 - fg], axis=-1)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(means=f32(means), colors=f32(colors), segmentation_masks=f32(seg),
                rotation_quaternions=f32(quats), opacity_logits=f32(opacity_logits),
                log_scales=f32(log_scales))


def make_random_cloud(seed: int, n: int, capacity: int | None = None, device="cuda",
                      **kw) -> GaussianCloud:
    """``random_cloud_arrays(seed, n, **kw)`` as a cloud of ``capacity`` rows."""
    return cloud_from_arrays(**random_cloud_arrays(seed, n, **kw), capacity=capacity,
                             device=device)


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
