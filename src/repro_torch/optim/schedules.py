"""Learning-rate schedules, the port of ``repro.optim.schedules``: each
returns a function of the step giving the rate as a float32 scalar
tensor, computed in float32 as the JAX package does."""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.0) -> Schedule:
    def f(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f


def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32)
