"""Learning-rate schedules (the JAX package's ``optim/schedules.py``).

``wsd_schedule`` is the MiniCPM Warmup-Stable-Decay schedule
(arXiv:2404.06395): linear warmup, long flat stable phase, short
exponential-ish decay tail — assigned to minicpm-2b.

A schedule maps a step to the learning rate as a 0-d float32 tensor,
computed in float32 from the step as the reference traces it. The step
is a Python int (made on ``device`` by a fill kernel, so no host copy
waits for the card) or an integer tensor (the lr lands on its device).
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[..., torch.Tensor]


def _step_f32(step: Step, device) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.full((), float(step), dtype=torch.float32, device=device)


def cosine_schedule(peak_lr: float, total_steps: int,
                    warmup_steps: int = 100,
                    min_ratio: float = 0.1) -> Schedule:
    def fn(step: Step, device: "str | torch.device | None" = None
           ) -> torch.Tensor:
        step = _step_f32(step, device)
        warm = step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = frac.clamp(0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)

    return fn


def wsd_schedule(peak_lr: float, total_steps: int, warmup_steps: int = 100,
                 decay_frac: float = 0.1, min_ratio: float = 0.01) -> Schedule:
    """Warmup -> stable plateau -> fast decay over the last ``decay_frac``."""

    decay_steps = max(1, int(total_steps * decay_frac))
    decay_start = total_steps - decay_steps

    def fn(step: Step, device: "str | torch.device | None" = None
           ) -> torch.Tensor:
        step = _step_f32(step, device)
        warm = step / max(warmup_steps, 1)
        decay_t = ((step - decay_start) / decay_steps).clamp(0.0, 1.0)
        # exponential decay to min_ratio over the tail; the log in float32,
        # as the reference takes it
        log_min = torch.log(torch.full((), min_ratio, dtype=torch.float32,
                                       device=step.device))
        decay = torch.exp(log_min * decay_t)
        val = torch.where(step < warmup_steps, warm,
                          torch.where(step < decay_start,
                                      torch.ones_like(step), decay))
        return peak_lr * val

    return fn


def make_schedule(kind: str, peak_lr: float, total_steps: int,
                  warmup_steps: int = 100) -> Schedule:
    if kind == "wsd":
        return wsd_schedule(peak_lr, total_steps, warmup_steps)
    return cosine_schedule(peak_lr, total_steps, warmup_steps)
