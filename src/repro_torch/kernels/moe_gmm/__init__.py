"""Batched expert product (E, C, D) x (E, D, F) of the capacity-buffer
MoE."""
from .kernel import expert_matmul_cuda, expert_matmul_design
from .ops import expert_matmul
from .ref import expert_matmul_ref

__all__ = ["expert_matmul", "expert_matmul_cuda", "expert_matmul_design",
           "expert_matmul_ref"]
