"""Spherical-harmonics colour evaluation, degrees 0-3, eval only (port of
``splatpu/core/sh.py``).

No path of either package calls it: the reference's rasterizer call sites
fix ``sh_degree=0`` and pass precomputed colours.  A cloud that carries SH
coefficients can be turned into per-Gaussian view-dependent RGB here and
rendered through the ordinary ``colors`` argument.

The constants and the band-major coefficient layout are the 3DGS family's:
direction = normalize(mean - camera centre), output = sum_k coeffs[k] *
basis_k(dir) + 0.5, clamped at 0.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(N, 3) unit directions -> (N, (degree + 1)^2) real SH basis values,
    band-major."""
    if not 0 <= degree <= 3:
        raise ValueError(f"sh degree must be in [0, 3], got {degree}")
    n = dirs.shape[0]
    cols = [torch.full((n,), SH_C0, dtype=dirs.dtype, device=dirs.device)]
    if degree >= 1:
        x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        cols += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(cols, dim=1)


def eval_sh_colors(
    coeffs: torch.Tensor,         # (N, K, 3) with K = (degree + 1)^2
    means: torch.Tensor,          # (N, 3)
    camera_center: torch.Tensor,  # (3,)
    degree: int | None = None,
) -> torch.Tensor:
    """View-dependent RGB from SH coefficients: (N, 3), >= 0."""
    if degree is None:
        degree = int(round(coeffs.shape[1] ** 0.5)) - 1
    if num_sh_coeffs(degree) != coeffs.shape[1]:
        raise ValueError(f"coeffs K={coeffs.shape[1]} does not match degree {degree}")
    d = means - camera_center[None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-12)
    basis = sh_basis(d, degree)
    rgb = torch.einsum("nk,nkc->nc", basis, coeffs) + 0.5
    return torch.clamp(rgb, min=0.0)
