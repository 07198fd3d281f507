"""Dispatch for the batched expert product: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs the plain version.  Nothing falls
back from one to the other."""
from __future__ import annotations

import torch

from .kernel import expert_matmul_cuda
from .ref import expert_matmul_ref


def expert_matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D); w: (E, D, F). Returns (E, C, F) in buf's dtype."""
    if buf.is_cuda:
        return expert_matmul_cuda(buf, w)
    return expert_matmul_ref(buf, w)
