"""Plain PyTorch version of the linear recurrence h_t = a_t h_{t-1} + b_t.

The counterpart of ``repro.kernels.linear_scan.ref.linear_scan_ref``: a
sequential loop over ``S`` in float32.  The CUDA kernel walks each
channel in the same order with the same rounded multiply and add, so on
the card the two agree bit for bit.
"""
from __future__ import annotations

import torch


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) float32.  Returns h: (B, S, D), h_{-1} = 0."""
    B, S, D = a.shape
    h = torch.zeros((B, D), dtype=a.dtype, device=a.device)
    out = torch.empty_like(a)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
