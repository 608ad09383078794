"""Gaussian cloud, camera and render-argument types (port of
``splatpu/core/types.py``).

The JAX package keeps the cloud at a fixed capacity with an ``alive`` mask so
that XLA shapes stay static; the port keeps the same layout so that clouds
written by ``splatpu`` load unchanged, and dead slots still render with
opacity 0.  Tensors carry their own device; nothing here moves data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from splatpu_torch.core.quaternion import quat_normalize

CLOUD_PARAMS = (
    "means",
    "colors",
    "segmentation_masks",
    "rotation_quaternions",
    "opacity_logits",
    "log_scales",
)


@dataclasses.dataclass
class GaussianCloud:
    """Raw (pre-activation) Gaussian parameters, leading dim = capacity."""

    means: torch.Tensor                 # (CAP, 3) float32
    colors: torch.Tensor                # (CAP, 3) float32
    segmentation_masks: torch.Tensor    # (CAP, 3) float32
    rotation_quaternions: torch.Tensor  # (CAP, 4) float32 (w, x, y, z)
    opacity_logits: torch.Tensor        # (CAP, 1) float32
    log_scales: torch.Tensor            # (CAP, 3) float32
    alive: torch.Tensor                 # (CAP,) bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def param_dict(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in CLOUD_PARAMS}

    def replace(self, **changes) -> "GaussianCloud":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "GaussianCloud":
        return GaussianCloud(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


@dataclasses.dataclass
class Camera:
    """Pinhole camera: world-to-camera extrinsics, intrinsics, image size.

    ``w2c`` is (4, 4) and ``K`` is (3, 3) for one view, or (V, 4, 4) and
    (V, 3, 3) for V views of the same size (the port's batched view
    dimension; the JAX package vmaps over stacked cameras instead).
    """

    w2c: torch.Tensor
    K: torch.Tensor
    width: int
    height: int
    near: float = 1.0
    far: float = 100.0

    @property
    def batched(self) -> bool:
        return self.w2c.dim() == 3

    @property
    def num_views(self) -> int:
        return self.w2c.shape[0] if self.batched else 1

    def view(self, i: int) -> "Camera":
        """The i-th view of a batched camera as a single-view camera."""
        if not self.batched:
            if i != 0:
                raise IndexError(i)
            return self
        return dataclasses.replace(self, w2c=self.w2c[i], K=self.K[i])

    @property
    def fx(self):
        return self.K[..., 0, 0]

    @property
    def fy(self):
        return self.K[..., 1, 1]

    @property
    def cx(self):
        return self.K[..., 0, 2]

    @property
    def cy(self):
        return self.K[..., 1, 2]

    # Tensor / tensor: a Python numerator would be applied as a reciprocal
    # multiply, which rounds differently from the reference's division.
    @property
    def tan_fovx(self):
        return torch.full_like(self.fx, self.width) / (2.0 * self.fx)

    @property
    def tan_fovy(self):
        return torch.full_like(self.fy, self.height) / (2.0 * self.fy)


def stack_cameras(cameras: list[Camera]) -> Camera:
    """Single-view cameras of one size -> one batched camera."""
    if not cameras:
        raise ValueError("empty camera list")
    c0 = cameras[0]
    static = lambda c: (c.width, c.height, c.near, c.far)  # noqa: E731
    for c in cameras[1:]:
        if static(c) != static(c0):
            raise ValueError("cannot stack cameras with differing static fields")
    return dataclasses.replace(
        c0,
        w2c=torch.stack([c.w2c for c in cameras]),
        K=torch.stack([c.K for c in cameras]),
    )


@dataclasses.dataclass
class RenderArgs:
    """Activated per-Gaussian quantities the renderer consumes.

    The JAX package's ``means2d_offset`` screen-gradient collector is left
    out: the port's render is forward-only until the training slice.
    """

    means3d: torch.Tensor    # (N, 3)
    colors: torch.Tensor     # (N, C)
    rotations: torch.Tensor  # (N, 4) unit quaternions
    opacities: torch.Tensor  # (N, 1) in [0, 1]
    scales: torch.Tensor     # (N, 3) positive

    @property
    def n(self) -> int:
        return self.means3d.shape[0]


def activate_cloud(
    cloud: GaussianCloud, colors: Optional[torch.Tensor] = None
) -> RenderArgs:
    """Sigmoid opacities (0 on dead slots), normalised quaternions, exp
    scales (``splatpu/core/types.py:206-224``)."""
    opacity = torch.sigmoid(cloud.opacity_logits)
    opacity = torch.where(cloud.alive[:, None], opacity, torch.zeros_like(opacity))
    return RenderArgs(
        means3d=cloud.means,
        colors=cloud.colors if colors is None else colors,
        rotations=quat_normalize(cloud.rotation_quaternions),
        opacities=opacity,
        scales=torch.exp(cloud.log_scales),
    )
