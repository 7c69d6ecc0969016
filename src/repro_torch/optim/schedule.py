"""LR schedules (cosine with linear warmup; constant for smoke tests).

Counterpart of the JAX package's ``optim/schedule.py``, with its float32
formulas in the same order.  A schedule takes a step as an int or a 0-d
tensor and returns a float32 0-d tensor on the step's device (the CPU for
an int), so a train step reads nothing back to the host.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine, rounded from float64: torch's float32 ``cos`` is a
    unit in the last place off the reference's correctly rounded values at
    some of a schedule's steps."""
    return torch.cos(x.double()).to(torch.float32)


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def schedule(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + _cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_step(step).device)
