"""Loss weights and the image loss (port of ``splatpu/train/losses.py``).

Stage 2's total is 0.8 * sum_views L1 + 0.2 * sum_views (1 - SSIM) +
3 * views * rigidity (the rigidity term is identical per view).
"""

from __future__ import annotations

import torch

from splatpu_torch.core.ssim import ssim

L1_WEIGHT = 0.8
SSIM_WEIGHT = 0.2
RIGIDITY_WEIGHT = 3.0


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def image_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return L1_WEIGHT * l1_loss(rendered, target) + SSIM_WEIGHT * (1.0 - ssim(rendered, target))
