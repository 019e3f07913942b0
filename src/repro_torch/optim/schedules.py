"""Learning-rate schedules as ``step -> lr`` callables (f32 on the step's
device). Port of ``repro.optim.schedules``."""

from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return fn


def inverse_time_schedule(lr0: float, decay: float):
    """η_t = η₀ / (1 + decay·t) — the decreasing-step recipe of Remark 1
    (the Theorem-1 error floor vanishes as T→∞)."""

    def fn(step):
        lr = torch.full((), lr0, dtype=torch.float32, device=step.device)
        return lr / (1.0 + decay * step.to(torch.float32))

    return fn


def cosine_schedule(lr0: float, total_steps: int, lr_min: float = 0.0):
    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / max(total_steps, 1),
                           0.0, 1.0)
        return lr_min + 0.5 * (lr0 - lr_min) * (1.0 + torch.cos(math.pi * frac))

    return fn


def warmup_cosine_schedule(lr0: float, warmup_steps: int, total_steps: int,
                           lr_min: float = 0.0):
    cos = cosine_schedule(lr0, max(total_steps - warmup_steps, 1), lr_min)

    def fn(step):
        warm = lr0 * step.to(torch.float32) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
