"""LR schedules (pure functions of the step). Port of
``repro.optim.schedule``: f32 arithmetic, a 0-d f32 tensor out."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1, device=None) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    warm = base_lr * step / max(1, warmup)
    frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, base_lr * cos)
