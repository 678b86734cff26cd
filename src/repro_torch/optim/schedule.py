"""Learning-rate schedules: float32 functions of a step tensor, as the
reference's."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def cosine_schedule(step, total_steps: int, peak: float, floor: float = 0.0):
    frac = torch.clamp(step.to(F32) / max(total_steps, 1), 0.0, 1.0)
    return floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))


def linear_warmup_cosine(step, warmup: int, total_steps: int, peak: float,
                         floor: float = 0.0):
    """Linear from 0 at step 0 to ``peak`` at ``warmup``, then a cosine to
    ``floor`` at ``total_steps``.  Step 0 gives a learning rate of 0, so
    the first update moves only the moments and the count."""
    step = step.to(F32)
    warm = peak * step / max(warmup, 1)
    decay_frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                             0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * decay_frac))
    return torch.where(step < warmup, warm, cos)
