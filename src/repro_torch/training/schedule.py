"""Learning-rate schedules (pure functions of the step counter), the
reference's `repro/training/schedule.py`."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, warmup: int = 200, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup over `warmup` steps, then a cosine from 1 down to
    `floor` at `total`; a float32 scalar tensor (on `step`'s device when
    `step` is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * progress))
    return warm * cos


def constant(step) -> float:
    return 1.0
