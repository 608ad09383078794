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

    def n_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def param_dict(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in CLOUD_PARAMS}

    def replace(self, **changes) -> "GaussianCloud":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "GaussianCloud":
        return GaussianCloud(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


def cloud_from_arrays(
    means,
    colors,
    segmentation_masks,
    rotation_quaternions,
    opacity_logits,
    log_scales,
    capacity: Optional[int] = None,
    device="cuda",
) -> GaussianCloud:
    """A cloud from dense (N, .) arrays, padded up to ``capacity`` with dead
    rows of benign values (identity quaternions, opacity logit -20, log
    scale -10), as ``splatpu/core/types.py:67-105`` pads."""
    arrays = dict(means=means, colors=colors, segmentation_masks=segmentation_masks,
                  rotation_quaternions=rotation_quaternions, opacity_logits=opacity_logits,
                  log_scales=log_scales)
    n = arrays["means"].shape[0]
    cap = n if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    fill = {"opacity_logits": -20.0, "log_scales": -10.0}

    def pad(k):
        a = torch.as_tensor(arrays[k], dtype=torch.float32, device=device)
        block = torch.full((cap - n,) + tuple(a.shape[1:]), fill.get(k, 0.0),
                           dtype=torch.float32, device=device)
        if k == "rotation_quaternions":
            block[:, 0] = 1.0
        return torch.cat([a, block])

    return GaussianCloud(alive=torch.arange(cap, device=device) < n,
                         **{k: pad(k) for k in CLOUD_PARAMS})


@dataclasses.dataclass
class Camera:
    """Pinhole camera: world-to-camera extrinsics, intrinsics, image size.

    ``w2c`` is (4, 4) and ``K`` is (3, 3) for one view, or (V, 4, 4) and
    (V, 3, 3) for V views of the same size (the port's batched view
    dimension; the JAX package vmaps over stacked cameras instead).

    ``fov_width`` / ``fov_height`` (default: the image's size) are the
    size of the image that ``K`` describes, whose field of view the
    projection, the EWA frustum clamp and the ``means2d_offset`` pixel
    scale read; ``row_offset`` is the first of its rows that this camera
    renders.  A strip of a larger image (``dist/tile_sharding.py``) keeps
    the whole image's ``K`` and size and renders ``height`` rows from
    ``row_offset``: its pixel positions are the whole image's less
    ``row_offset``, exactly, so its pixels are the whole render's rows.
    """

    w2c: torch.Tensor
    K: torch.Tensor
    width: int
    height: int
    near: float = 1.0
    far: float = 100.0
    fov_width: Optional[int] = None
    fov_height: Optional[int] = None
    row_offset: int = 0

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
        return torch.full_like(self.fx, self.fov_width or self.width) / (2.0 * self.fx)

    @property
    def tan_fovy(self):
        return torch.full_like(self.fy, self.fov_height or self.height) / (2.0 * self.fy)


def stack_cameras(cameras: list[Camera]) -> Camera:
    """Single-view cameras of one size -> one batched camera."""
    if not cameras:
        raise ValueError("empty camera list")
    c0 = cameras[0]
    static = lambda c: (c.width, c.height, c.near, c.far, c.fov_width, c.fov_height,  # noqa: E731
                        c.row_offset)
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

    ``means2d_offset`` is the screen-gradient collector that stage 1's
    densification reads: an additive zero in NDC units on each Gaussian's
    pixel position, whose gradient is the per-Gaussian screen-space
    gradient (``splatpu/core/types.py:186-207``).  ``None`` (the default)
    adds nothing.  It is (N, 2) for every view of a camera, or (V, N, 2)
    for a batched camera of V views, one slice per view, so that each view
    collects its own screen gradients.
    """

    means3d: torch.Tensor    # (N, 3)
    colors: torch.Tensor     # (N, C)
    rotations: torch.Tensor  # (N, 4) unit quaternions
    opacities: torch.Tensor  # (N, 1) in [0, 1]
    scales: torch.Tensor     # (N, 3) positive
    means2d_offset: Optional[torch.Tensor] = None  # (N, 2) or (V, N, 2)

    @property
    def n(self) -> int:
        return self.means3d.shape[0]

    def for_view(self, i: int) -> "RenderArgs":
        """The args of view ``i``: the offset's i-th slice where it is per view."""
        off = self.means2d_offset
        if off is None or off.dim() == 2:
            return self
        return dataclasses.replace(self, means2d_offset=off[i])


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
