"""Optimizers (port of ``splatpu/train/optim.py``).

``ScaleByAdam`` is optax's ``scale_by_adam`` written out: moments
(1 - b) g^k + b m, bias correction 1 - b^count with the incremented count,
eps outside the square root.  Its state is ``count`` and one ``mu`` / ``nu``
tensor per named parameter, so a JAX checkpoint's Adam state loads into it.

Stage 1: ``Stage1Adam`` (eps 1e-15, no schedule) and the reference's
per-group learning rates (``STAGE1_BASE_LRS``, the means' scaled by the
scene radius), applied by ``apply_stage1_updates``; densification edits its
moments in place (``growth/densify.py``).

Stage 2: ``Stage2Adam`` is optax's ``adam`` under the warmup-cosine
schedule, the closed form of torch's SequentialLR(LinearLR(1/1000 -> 1
over W steps), CosineAnnealingLR(T_max = total - W)), evaluated in float32
with the JAX package's order of operations; torch's own schedulers step
recursively and drift from it.  The learning rate is read at the update
count BEFORE the increment (the first update uses lr(0) = base / 1000).
"""

from __future__ import annotations

import math

import numpy as np
import torch

START_FACTOR = 1.0 / 1000.0


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """step -> float32 learning rate."""
    f32 = np.float32
    t_max = max(total_steps - warmup_steps, 1)
    w = f32(max(warmup_steps, 1))

    def schedule(step) -> float:
        s = f32(step)
        if s < warmup_steps:
            frac = f32(1.0 - START_FACTOR) * min(s, w) / w
            return float(f32(base_lr) * (f32(START_FACTOR) + frac))
        cos_step = max(s - f32(warmup_steps), f32(0.0))
        angle = f32(np.pi) * cos_step / f32(t_max)
        return float(f32(base_lr * 0.5) * (f32(1.0) + np.cos(angle, dtype=f32)))

    return schedule


def stage2_lr_at(base_lr: float, warmup_steps: int, total_steps: int, step: int) -> float:
    """The schedule in double precision on the host, for logging."""
    t_max = max(total_steps - warmup_steps, 1)
    w = max(warmup_steps, 1)
    if step < warmup_steps:
        return base_lr * (START_FACTOR + (1.0 - START_FACTOR) * min(step, w) / w)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * (step - warmup_steps) / t_max))


class ScaleByAdam:
    """optax ``scale_by_adam`` over a dict of named parameters."""

    def __init__(self, params: dict[str, torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def load_state(self, count: int, mu: dict, nu: dict) -> None:
        if mu.keys() != self.mu.keys() or nu.keys() != self.nu.keys():
            raise ValueError("Adam state names do not match the parameters")
        self.count = int(count)
        self.mu = {k: torch.as_tensor(mu[k]).to(self.mu[k]) for k in self.mu}
        self.nu = {k: torch.as_tensor(nu[k]).to(self.nu[k]) for k in self.nu}

    def bias_corrections(self, count: int) -> tuple[float, float]:
        """1 - b1^count and 1 - b2^count in float32, through numpy's pow (at
        count 6,001 the correctly rounded value, where JAX's eager pow on a
        CPU has given two ulps less)."""
        f32 = np.float32
        return (float(f32(1.0) - f32(self.b1) ** f32(count)),
                float(f32(1.0) - f32(self.b2) ** f32(count)))

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Advance the moments and the count; the bias-corrected updates."""
        count = self.count + 1
        bc1, bc2 = self.bias_corrections(count)
        updates = {}
        for k in self.mu:
            g = grads[k]
            mu = (1 - self.b1) * g + self.b1 * self.mu[k]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            updates[k] = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            self.mu[k], self.nu[k] = mu, nu
        self.count = count
        return updates


STAGE1_BASE_LRS = {
    # The reference's groups (``densify.py:69-78``); the means' lr is also
    # scaled by the scene radius.
    "means": 0.00016,
    "colors": 0.0025,
    "segmentation_masks": 0.0,
    "rotation_quaternions": 0.001,
    "opacity_logits": 0.05,
    "log_scales": 0.001,
}


def stage1_learning_rates(scene_radius: float) -> dict[str, float]:
    lrs = dict(STAGE1_BASE_LRS)
    lrs["means"] = lrs["means"] * float(scene_radius)
    return lrs


class Stage1Adam(ScaleByAdam):
    """Stage 1's Adam moments: ``scale_by_adam(eps=1e-15)``; the caller
    applies the per-group learning rates (``apply_stage1_updates``)."""

    def __init__(self, params: dict[str, torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-15):
        super().__init__(params, b1, b2, eps)


def apply_stage1_updates(params: dict, updates: dict, learning_rates: dict) -> dict:
    """params - lr_k * update_k for each group k."""
    return {k: params[k] - learning_rates[k] * updates[k] for k in params}


class Stage2Adam(ScaleByAdam):
    """optax ``adam(schedule)`` over a dict of named parameters."""

    def __init__(self, params: dict[str, torch.Tensor], schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, b1, b2, eps)
        self.schedule = schedule

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> float:
        """Update ``params`` in place; returns the learning rate used."""
        lr = self.schedule(self.count)
        for k, update in self.update(grads).items():
            params[k].add_(-lr * update)
        return lr


def make_stage2_optimizer(params, learning_rate: float, warmup_steps: int, total_steps: int):
    return Stage2Adam(params, warmup_cosine_schedule(learning_rate, warmup_steps, total_steps))
