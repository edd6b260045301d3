"""Learning-rate schedules (port of ``repro/optim/schedule.py``): pure
functions of the step index, which may be a device tensor (the train
step's counter: no host read) or an int.  They return a float32 tensor on
the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step))


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) *
                     0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_step(step), peak_lr)
