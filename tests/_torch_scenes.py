"""Shared inputs for the port's tests (tests/test_torch_*.py): scenes made
with numpy from a seed and handed to both packages (``_np_scenes.py``,
which the card's tests import without JAX), plus converters.

Not a test module itself; the port tests import it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import splatpu.core.types as jt
import splatpu_torch.core.types as tt
from _np_scenes import np_cloud, np_lookat  # noqa: F401


def jax_cloud(c: dict) -> jt.GaussianCloud:
    return jt.GaussianCloud(**{k: jnp.asarray(v) for k, v in c.items()})


def torch_cloud(c: dict) -> tt.GaussianCloud:
    return tt.GaussianCloud(**{k: torch.from_numpy(np.array(v)) for k, v in c.items()})


def jax_camera(w2c, K, width, height) -> jt.Camera:
    return jt.Camera(w2c=jnp.asarray(w2c), K=jnp.asarray(K), width=width, height=height)


def torch_camera(w2c, K, width, height) -> tt.Camera:
    return tt.Camera(w2c=torch.from_numpy(np.array(w2c)), K=torch.from_numpy(np.array(K)),
                     width=width, height=height)


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
