"""The numpy scenes of the port's tests (``_torch_scenes.py`` re-exports
them): raw clouds and look-at cameras from a seed.  Imports nothing of JAX,
so the tests that run on a card import it too.

Not a test module itself.
"""

from __future__ import annotations

import numpy as np


def np_cloud(seed: int, n: int, extent: float = 1.0, scale_range=(0.02, 0.08),
             opacity_range=(-1.0, 3.0), n_dead: int = 0) -> dict[str, np.ndarray]:
    """Raw cloud arrays (the npz layout), the last ``n_dead`` slots dead."""
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    fg = (rng.uniform(size=n) < 0.7).astype(np.float32)
    alive = np.ones(n, bool)
    if n_dead:
        alive[n - n_dead:] = False
    return {
        "means": rng.uniform(-extent, extent, (n, 3)).astype(np.float32),
        "colors": rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        "segmentation_masks": np.stack([fg, 0 * fg, 1 - fg], -1).astype(np.float32),
        "rotation_quaternions": quats,
        "opacity_logits": rng.uniform(*opacity_range, (n, 1)).astype(np.float32),
        "log_scales": np.log(rng.uniform(*scale_range, (n, 3))).astype(np.float32),
        "alive": alive,
    }


def np_lookat(eye=(0.0, 0.0, -4.0), width=64, height=64, focal=None):
    """(w2c, K) float32 of a look-at camera toward the origin."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    R = np.stack([right, up, fwd])
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    f = 0.8 * max(width, height) if focal is None else focal
    K = np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]])
    return w2c.astype(np.float32), K.astype(np.float32)
