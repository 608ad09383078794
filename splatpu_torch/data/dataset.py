"""One (timestep, camera) observation (port of
``splatpu/data/dataset.py:27-37``).  The on-disk sequence loader is not
ported yet; trainers take lists of ``ViewData`` per timestep."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ViewData:
    """One (timestep, camera) observation, host-side numpy."""

    camera_index: int
    w2c: np.ndarray           # (4, 4)
    K: np.ndarray             # (3, 3)
    width: int
    height: int
    image: np.ndarray         # (3, H, W) float32 in [0, 1], or uint8
    segmentation: np.ndarray  # (3, H, W) float32 channels (fg, 0, bg)
