"""Differentiable attention: the port of the JAX package's
``jax.custom_vjp`` op (``repro.kernels.flash_attention.ops``).

The forward dispatches by device: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs the plain version; nothing falls back from one
to the other.  The backward recomputes attention through the plain
version and differentiates it, as the JAX package does (it has no
backward kernel): the numbers of ``ref.py``'s gradient, with the score
matrix alive only inside the backward of one layer.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref


def _attend(q, k, v, causal: bool, window: int, scale: Optional[float]):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, window, scale)
    return attention_ref(q, k, v, causal, window, scale)


class FlashAttention(torch.autograd.Function):
    """Kernel forward, plain-recompute backward; saves q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                scale: Optional[float]):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        return _attend(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_ref(*inputs, *ctx.args)
        dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d). Returns (B, Sq, Hq, d);
    differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, window, scale)
