"""Loss weights and the image loss (port of ``splatpu/train/losses.py``).

Stage 1's total is image_loss + 3 * image_loss of the segmentation render;
stage 2's is 0.8 * sum_views L1 + 0.2 * sum_views (1 - SSIM) +
3 * views * rigidity (the rigidity term is identical per view).
"""

from __future__ import annotations

import torch

from splatpu_torch.core.ssim import ssim

L1_WEIGHT = 0.8
SSIM_WEIGHT = 0.2
SEGMENTATION_WEIGHT = 3.0
RIGIDITY_WEIGHT = 3.0


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def image_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return L1_WEIGHT * l1_loss(rendered, target) + SSIM_WEIGHT * (1.0 - ssim(rendered, target))


def image_losses(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``image_loss`` of each view of (V, C, H, W) batches: (V,)."""
    l1 = (rendered - target).abs().mean(dim=(1, 2, 3))
    return L1_WEIGHT * l1 + SSIM_WEIGHT * (1.0 - ssim(rendered, target, size_average=False))
