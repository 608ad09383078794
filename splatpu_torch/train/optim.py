"""Stage-2 optimizer: Adam under the warmup-cosine schedule (port of
``splatpu/train/optim.py:52-102``).

The schedule is the closed form of torch's SequentialLR(LinearLR(1/1000 ->
1 over W steps), CosineAnnealingLR(T_max = total - W)), evaluated in
float32 with the JAX package's order of operations; torch's own schedulers
step recursively and drift from it.  ``Stage2Adam`` is optax's ``adam``
written out: moments (1 - b) g^k + b m, bias correction 1 - b^count with the
incremented count, eps 1e-8 outside the square root, and the learning rate
read at the update count BEFORE the increment (the first update uses
lr(0) = base / 1000).  Its state is ``count`` and one ``mu`` / ``nu`` tensor
per parameter of a ``state_dict``-style name, so a JAX checkpoint's Adam
state loads into it (``io.checkpoint.load_stage2_opt_state``).
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


class Stage2Adam:
    """optax ``adam(schedule)`` over a dict of named parameters."""

    def __init__(self, params: dict[str, torch.Tensor], schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def load_state(self, count: int, mu: dict, nu: dict) -> None:
        if mu.keys() != self.mu.keys() or nu.keys() != self.nu.keys():
            raise ValueError("Adam state names do not match the parameters")
        self.count = int(count)
        self.mu = {k: mu[k].to(self.mu[k]) for k in self.mu}
        self.nu = {k: nu[k].to(self.nu[k]) for k in self.nu}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> float:
        """Update ``params`` in place; returns the learning rate used."""
        f32 = np.float32
        lr = self.schedule(self.count)
        count = self.count + 1
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        for k, p in params.items():
            g = grads[k]
            mu = (1 - self.b1) * g + self.b1 * self.mu[k]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-lr * update)
            self.mu[k], self.nu[k] = mu, nu
        self.count = count
        return lr


def make_stage2_optimizer(params, learning_rate: float, warmup_steps: int, total_steps: int):
    return Stage2Adam(params, warmup_cosine_schedule(learning_rate, warmup_steps, total_steps))
