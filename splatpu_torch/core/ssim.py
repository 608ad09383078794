"""Windowed SSIM (port of ``splatpu/core/ssim.py``).

11-tap Gaussian window (sigma 1.5, normalised to sum 1), zero "SAME"
padding, per channel, c1 = 0.01^2, c2 = 0.03^2.  The 2D window is the outer
product of the 1D one, so the blur runs as two 1D passes (rows, then
columns), each as 11 shifted scaled adds in the JAX package's order.  No
convolution is used: a float32 convolution on the card goes through cuDNN,
in TF32 by default, and would keep only about three decimal digits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> tuple[float, ...]:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return tuple(float(x) for x in (g / g.sum()).astype(np.float32))


def _blur1d(img: torch.Tensor, window: tuple[float, ...], dim: int) -> torch.Tensor:
    """Zero-padded "SAME" 1D blur along ``dim`` (2 or 3 of (B, C, H, W))."""
    k = len(window)
    r = k // 2
    pad = (0, 0, r, r) if dim == 2 else (r, r, 0, 0)
    p = F.pad(img, pad)
    size = img.shape[dim]
    out = None
    for d in range(k):
        term = window[d] * p.narrow(dim, d, size)
        out = term if out is None else out + term
    return out


def _blur(img, window):
    return _blur1d(_blur1d(img, window, 2), window, 3)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5, size_average: bool = True):
    """SSIM of images shaped (C, H, W) or (B, C, H, W): the mean over all
    values (``size_average``), or one mean per batch entry."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    window = _gaussian_1d(window_size, sigma)
    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu1_mu2
    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
