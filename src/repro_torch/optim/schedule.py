"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to `peak_lr` over `warmup_steps`, then a cosine decay
    to `min_ratio * peak_lr` at `total_steps`.  A 0-d fp32 tensor, computed
    in fp32 as the JAX package does, on the step's device (the host for an
    int step: a 0-d host tensor scales a card tensor without a copy)."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(float(step), dtype=torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
