"""Learning-rate schedules as step -> lr callables (counterpart of
``repro.optim.schedules``).

Each takes an int32 step tensor and returns an fp32 tensor on the step's
device, computed in fp32 as the JAX versions are (``step / n`` of an int32
step is an fp32 division there).
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant_schedule", "cosine_schedule", "linear_warmup_cosine"]


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return peak_lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(peak_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def fn(step):
        warm = peak_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return fn
