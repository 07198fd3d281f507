"""The differentiable batched expert product.

Forward and backward dispatch by device: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs the plain version, a ``meta``
tensor makes the kernel's output (``torch.empty`` of (E, C, F) in buf's
dtype, contiguous); nothing falls back from one to another.  Each
product is tallied in ``kernels.tally.OP_TALLY["expert_matmul"]`` on
every device.  The backward of Y = X W per expert is two more products
through the same op, on transposed contiguous operands:
    dX = dY W^T       (E, C, F) x (E, F, D)
    dW = X^T dY       (E, D, C) x (E, C, F)
(The JAX package's MoE computes the products with einsum and lets XLA
differentiate them; the oracle is autograd of the plain product.)
"""
from __future__ import annotations

import torch

from .. import tally
from .kernel import expert_matmul_cuda
from .ref import expert_matmul_ref


def _dispatch(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if buf.is_cuda:
        return expert_matmul_cuda(buf, w)
    if buf.is_meta:
        return buf.new_empty((*buf.shape[:2], w.shape[2]))
    return expert_matmul_ref(buf, w)


def _matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    flops, nbytes = tally.expert_work(buf, w)
    return tally.run("expert_matmul", flops, nbytes, _dispatch, buf, w)


class ExpertMatmul(torch.autograd.Function):
    """Y = X W per expert, whose backward is two more expert products."""

    @staticmethod
    def forward(ctx, buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(buf, w)
        return _matmul(buf, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        buf, w = ctx.saved_tensors
        g = g.contiguous()
        dbuf = dw = None
        if ctx.needs_input_grad[0]:
            dbuf = _matmul(g, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = _matmul(buf.transpose(1, 2).contiguous(), g)
        return dbuf, dw


def expert_matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D); w: (E, D, F). Returns (E, C, F) in buf's dtype;
    differentiable in buf and w."""
    return ExpertMatmul.apply(buf, w)
