"""Port of ``repro/optim/schedule.py``: LR schedules, linear warmup then
cosine (the production default), linear or constant, all in f32.  The lr
at step 0 is 0 under warmup, so a first update moves nothing."""
from __future__ import annotations

import math

import torch

__all__ = ["make_schedule"]


def make_schedule(kind: str = "cosine", *, peak_lr: float = 3e-4,
                  warmup_steps: int = 100, total_steps: int = 10_000,
                  final_frac: float = 0.1):
    """``sched(step)`` -> the lr as an f32 tensor on ``step``'s device (a
    Python int gives a CPU scalar).  A device step is read on the device
    only, so a captured train step computes each replay's lr from its own
    step count."""
    def sched(step):
        s = step.to(torch.float32) if isinstance(step, torch.Tensor) \
            else torch.tensor(float(step))
        warm = peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        if kind == "constant":
            return warm
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        if kind == "linear":
            decay = peak_lr * (1.0 - (1.0 - final_frac) * prog)
        else:  # cosine
            decay = peak_lr * (final_frac + (1 - final_frac) * 0.5
                               * (1.0 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, decay)
    return sched
