"""Learning-rate schedules as ``step -> scale`` functions of a 0-d int
tensor, returning a 0-d float32 tensor on its device (the JAX package's
``optim/schedules.py``)."""
from __future__ import annotations

import math

import torch


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)


def linear_warmup(warmup_steps: int):
    def f(step):
        s = step.to(torch.float32)
        return torch.clamp((s + 1.0) / float(max(warmup_steps, 1)), max=1.0)
    return f


def cosine(total_steps: int, warmup_steps: int = 0, final_scale: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = torch.clamp((s + 1.0) / float(max(warmup_steps, 1)), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / float(max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = final_scale + (1 - final_scale) * 0.5 * \
            (1.0 + torch.cos(math.pi * frac))
        return warm * cos
    return f
