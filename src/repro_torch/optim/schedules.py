"""Learning-rate schedules: step (an integer tensor) -> lr."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = torch.clamp(step / max(warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, lr * w, cos(step - warmup))
    return f
