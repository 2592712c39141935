"""Learning-rate schedules (``repro.optim.schedules``): pure functions of
the step, computed in float32 as the reference computes them (its step is
an int32 array cast to float32).  Each returns a 0-dim float32 tensor on
the CPU."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32).to(torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def sched(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)

    return sched


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def sched(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return sched
