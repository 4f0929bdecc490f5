"""Learning-rate schedules as step -> lr functions, mirroring
``repro/optim/schedule.py``.

Each takes an int step, a scalar int tensor, or a [C] tensor of steps
for an entity stacked over C rows, and returns a float32 tensor of that
shape on the step's device; nothing reads the step back to the host.
"""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.as_tensor(step, dtype=torch.float32, device=device)


def constant(lr: float):
    def f(step):
        s = _steps(step)
        return torch.full_like(s, lr)
    return f


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    if warmup < 0:
        raise ValueError(f"cosine schedule: warmup={warmup} must be >= 0")
    if total <= warmup:
        # max(1, total - warmup) would silently collapse the decay
        # window to a single step (lr cliffs from lr to final_frac*lr
        # between steps `warmup` and `warmup+1`): reject upfront
        raise ValueError(f"cosine schedule: total={total} must exceed "
                         f"warmup={warmup} (no decay window otherwise)")

    def f(step):
        s = _steps(step)
        warm = lr * torch.clamp(s / max(1, warmup), max=1.0)
        prog = torch.clamp((s - warmup) / (total - warmup), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, lr * cos)
    return f


def exponential_decay(lr: float, decay: float, every: int):
    def f(step):
        s = _steps(step)
        return lr * torch.pow(decay, s / every)
    return f
