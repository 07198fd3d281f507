"""Dispatch for the linear recurrence: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs the plain version.  Nothing falls
back from one to the other."""
from __future__ import annotations

import torch

from .kernel import linear_scan_cuda
from .ref import linear_scan_ref


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) float32. Returns h with h_t = a_t h_{t-1} + b_t,
    h_0 = b_0."""
    if a.is_cuda:
        return linear_scan_cuda(a, b)
    return linear_scan_ref(a, b)
