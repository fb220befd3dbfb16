"""Learning-rate schedules.  Port of ``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor * peak``; ``step`` an int
    or a tensor, the result an f32 tensor on its device."""
    s = (step.float() if torch.is_tensor(step)
         else torch.tensor(float(step), dtype=torch.float32))
    warm = peak * torch.clamp(s / max(warmup, 1), max=1.0)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, cos)
