"""Learning-rate schedules: step -> float32 0-d tensor.

Counterpart of ``repro.optim.schedules``.  GBA's tuning-free contract means
the schedule follows *global steps*, which the buffer keeps aligned across
modes (K = ceil(Q/M) steps a day whatever the worker count), so a schedule
tuned under sync stays valid after switching:

    params, state = opt.update(params, grads, state,
                               lr_override=schedule(step))

``step`` is an int or a 0-d tensor; the result lies on the step's device
(the CPU for an int).  The schedules branch with ``torch.where``, never in
Python on the step, so a step held on the card needs no sync.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int | torch.Tensor], torch.Tensor]


def _f32(step: int | torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr``, then a half cosine down to
    ``final_frac * peak_lr`` at ``total_steps``, flat after it."""
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def inverse_sqrt(peak_lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup, then ``peak_lr * sqrt(warmup_steps / step)``."""
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.sqrt(
            warmup_steps / torch.clamp(step, min=warmup_steps))
        return torch.where(step < warmup_steps, warm, decay)

    return fn


def step_decay(lr: float, boundaries: tuple[int, ...],
               factors: tuple[float, ...]) -> Schedule:
    """``lr * factors[i]`` from ``boundaries[i]`` on (the last boundary
    passed wins), ``lr`` before the first."""
    def fn(step):
        step = torch.as_tensor(step)
        out = torch.full((), lr, dtype=torch.float32, device=step.device)
        for b, f in zip(boundaries, factors):
            out = torch.where(step >= b, lr * f, out)
        return out

    return fn


__all__ = ["Schedule", "constant", "inverse_sqrt", "step_decay",
           "warmup_cosine"]
