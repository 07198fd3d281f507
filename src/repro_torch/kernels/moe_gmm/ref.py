"""Plain PyTorch version of the batched expert product.

The counterpart of ``repro.kernels.moe_gmm.ref.expert_matmul_ref``: both
operands upcast to float32, one batched product over the experts, the
result cast back to ``buf``'s dtype.  The CUDA kernel accumulates in
float32 too, in another order.
"""
from __future__ import annotations

import torch


def expert_matmul_ref(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D); w: (E, D, F) -> (E, C, F), fp32 accumulation."""
    return torch.bmm(buf.float(), w.float()).to(buf.dtype)
