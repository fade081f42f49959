"""Learning-rate schedules: functions of the step (an int32 tensor) that
return the rate as an f32 tensor on the step's device, as
``repro.optim.schedules`` does with ``jnp``."""

from __future__ import annotations

import math

import torch


def constant(value: float):
    def fn(step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(value, dtype=torch.float32, device=step.device)

    return fn


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step: torch.Tensor) -> torch.Tensor:
        frac = (step.float() / total_steps).clamp(0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))

    return fn


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(1, warmup_steps)
        frac = ((s - warmup_steps) / max(1, total_steps - warmup_steps)).clamp(0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


__all__ = ["constant", "cosine_decay", "linear_warmup_cosine"]
