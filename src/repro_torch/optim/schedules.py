"""LR schedules (``repro/optim/schedules.py``): pure functions of the step
counter, in fp32 like the reference's."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``."""

    def fn(step):
        step = torch.as_tensor(step).float()
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)

    return fn


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
