"""Learning-rate schedules.  Port of ``repro/optim/schedule.py``."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to ``floor_frac * peak``, in fp32.

    ``step`` may be a tensor on the device (the optimizer's step count), so
    that reading the rate never waits on the device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    floor = floor_frac * peak_lr
    cos = floor + 0.5 * (peak_lr - floor) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
