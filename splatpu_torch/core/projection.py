"""Camera projection and EWA splatting (port of ``splatpu/core/projection.py``).

Per-Gaussian "preprocess": view-space position, pixel coordinates through the
principal-point-aware OpenGL projection with the ``ndc2Pix`` convention, the
3D covariance R diag(s^2) R^T pushed through the perspective Jacobian with the
1.3 tan-fov frustum clamp, +0.3 px dilation, conic = inverse 2D covariance,
screen radius = ceil(3 sigma_max), near cull at view z 0.2.

Everything stays as (N,) columns and unrolled products, in the same order of
operations as the JAX package, so that both give the same float32 values up
to rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from splatpu_torch.core.quaternion import rotation_entries
from splatpu_torch.core.types import Camera, RenderArgs

NEAR_CULL_Z = 0.2
COV2D_DILATION = 0.3
RADIUS_SIGMA = 3.0
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4


def projection_size(camera: Camera) -> tuple[int, int]:
    """The size of the image ``camera.K`` describes (the FOV size)."""
    return camera.fov_width or camera.width, camera.fov_height or camera.height


def opengl_projection_matrix(camera: Camera) -> torch.Tensor:
    """The principal-point-aware perspective matrix of one view (P @ x)."""
    w, h = projection_size(camera)
    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    n, f = camera.near, camera.far
    P = torch.zeros((4, 4), dtype=torch.float32, device=camera.K.device)
    P[0, 0] = 2 * fx / w
    P[0, 2] = -(w - 2 * cx) / w
    P[1, 1] = 2 * fy / h
    P[1, 2] = -(h - 2 * cy) / h
    P[2, 2] = f / (f - n)
    P[2, 3] = -(f * n) / (f - n)
    P[3, 2] = 1.0
    return P


def full_projection_matrix(camera: Camera) -> torch.Tensor:
    return opengl_projection_matrix(camera) @ camera.w2c


@dataclasses.dataclass
class Splats2D:
    """Per-Gaussian screen-space quantities of one view."""

    mean2d: torch.Tensor   # (N, 2) pixel coordinates
    depth: torch.Tensor    # (N,) view-space z
    conic: torch.Tensor    # (N, 3) (a, b, c) of [[a, b], [b, c]]
    radius: torch.Tensor   # (N,) float screen radius, 0 => culled
    visible: torch.Tensor  # (N,) bool


def offset_pixel_scale(camera: Camera) -> torch.Tensor:
    """Pixel scale of ``RenderArgs.means2d_offset``: half the full image's
    width and height (the FOV size), the CUDA rasterizer's d(pixel)/d(NDC),
    so that a strip collects screen gradients in the full render's units."""
    w, h = projection_size(camera)
    return torch.tensor([w * 0.5, h * 0.5], dtype=torch.float32, device=camera.K.device)


def compute_cov3d_columns(scales: torch.Tensor, rotations: torch.Tensor):
    """Sigma = R diag(s^2) R^T as a 3x3 nest of (N,) columns."""
    R = rotation_entries(rotations, eps=1e-12)
    s = [scales[:, 0], scales[:, 1], scales[:, 2]]
    RS = [[R[i][k] * s[k] for k in range(3)] for i in range(3)]
    return [
        [RS[i][0] * RS[j][0] + RS[i][1] * RS[j][1] + RS[i][2] * RS[j][2] for j in range(3)]
        for i in range(3)
    ]


def _matvec_rows(M, v3, bias):
    """(R, 3) @ (N, 3)^T + (R,) -> (N, R), unrolled like the JAX package."""
    return torch.stack(
        [
            v3[:, 0] * M[r, 0] + v3[:, 1] * M[r, 1] + v3[:, 2] * M[r, 2] + bias[r]
            for r in range(M.shape[0])
        ],
        dim=-1,
    )


def preprocess(args: RenderArgs, camera: Camera) -> Splats2D:
    """Project the Gaussians into one (unbatched) view."""
    t = projection_terms(args, camera)
    return Splats2D(mean2d=t["mean2d"], depth=t["tz"], conic=t["conic"], radius=t["radius"],
                    visible=t["visible"])


def projection_terms(args: RenderArgs, camera: Camera) -> dict:
    """``preprocess``'s intermediate values of one view, by their names
    there; the analytic backward of ``render/project.py`` reads them."""
    if camera.batched:
        raise ValueError("preprocess takes one view; use camera.view(i)")
    means = args.means3d
    Rw = camera.w2c[:3, :3]
    tw = camera.w2c[:3, 3]

    p_view = _matvec_rows(Rw, means, tw)
    tz = p_view[:, 2]
    in_front = tz > NEAR_CULL_Z

    P = full_projection_matrix(camera)
    p_hom = _matvec_rows(P[:, :3], means, P[:, 3])
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :2] * p_w[:, None]
    wh = torch.tensor(projection_size(camera), dtype=torch.float32, device=means.device)
    mean2d = ((ndc + 1.0) * wh - 1.0) * 0.5
    if args.means2d_offset is not None:
        # The screen-gradient collector: its pixel scale is half the image.
        if args.means2d_offset.dim() != 2:
            raise ValueError("preprocess takes one view's (N, 2) offset; use args.for_view(i)")
        mean2d = mean2d + args.means2d_offset * offset_pixel_scale(camera)
    if camera.row_offset:
        # A strip: the whole image's positions less its first row, exactly
        # (both are multiples of the position's ulp), so that every pixel
        # offset the composite forms is the whole render's.
        mean2d = mean2d - torch.tensor([0.0, float(camera.row_offset)], device=means.device)

    cov3d = compute_cov3d_columns(args.scales, args.rotations)
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    tz_safe = torch.where(tz == 0.0, torch.full_like(tz, 1e-6), tz)
    txtz = torch.clamp(p_view[:, 0] / tz_safe, -limx, limx)
    tytz = torch.clamp(p_view[:, 1] / tz_safe, -limy, limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    fx, fy = camera.fx, camera.fy
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    J_rows = [
        [fx * inv_z, zeros, -fx * tx * inv_z2],
        [zeros, fy * inv_z, -fy * ty * inv_z2],
    ]
    JW = [
        [J_rows[r][0] * Rw[0, b] + J_rows[r][1] * Rw[1, b] + J_rows[r][2] * Rw[2, b] for b in range(3)]
        for r in range(2)
    ]

    def cov2d_entry(r, c_):
        acc = 0.0
        for k in range(3):
            tmp = cov3d[k][0] * JW[c_][0] + cov3d[k][1] * JW[c_][1] + cov3d[k][2] * JW[c_][2]
            acc = acc + JW[r][k] * tmp
        return acc

    a = cov2d_entry(0, 0) + COV2D_DILATION
    b = cov2d_entry(0, 1)
    c = cov2d_entry(1, 1) + COV2D_DILATION

    det = a * c - b * b
    det_valid = det > 0.0
    det_safe = torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda_max = mid + disc
    radius = torch.ceil(RADIUS_SIGMA * torch.sqrt(lambda_max))

    visible = in_front & det_valid & (radius > 0.0) & (args.opacities[:, 0] > 0.0)
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    return locals()


def tile_rect(mean2d, radius, tiles_x: int, tiles_y: int, tile: int):
    """Covered-tile rectangle per Gaussian, half-open [tx0, tx1) x [ty0, ty1)."""
    x, y = mean2d[:, 0], mean2d[:, 1]

    def cell(v, hi, plus):
        # Clamp before the cast, so it is defined for far off-screen splats
        # on every device; the result after the clip is unchanged.
        f = torch.clamp(torch.floor(v / tile), -1.0, float(hi))
        return torch.clamp(f.to(torch.int32) + plus, 0, hi)

    return (
        cell(x - radius, tiles_x, 0),
        cell(y - radius, tiles_y, 0),
        cell(x + radius, tiles_x, 1),
        cell(y + radius, tiles_y, 1),
    )
