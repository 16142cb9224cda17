"""Learning-rate schedules, as :mod:`repro.optim.schedules`: functions
of an integer step that return an f32 scalar tensor (an optimizer's
callable ``lr``)."""
from __future__ import annotations

import math

import torch


def _step_f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak`` at ``total_steps`` (held after)."""
    def fn(step):
        s = _step_f32(step)
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def linear_decay(peak: float, total_steps: int):
    def fn(step):
        s = _step_f32(step)
        return peak * torch.clamp(1.0 - s / max(total_steps, 1), 0.0, 1.0)

    return fn
