"""Differentiable attention: the port of the JAX package's
``jax.custom_vjp`` op (``repro.kernels.flash_attention.ops``).

The forward dispatches by device: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs the plain version, a ``meta`` tensor makes the
kernel's output (``torch.empty`` of its shape and dtype, contiguous, and
nothing else, as the CUDA wrapper allocates only its output); nothing
falls back from one to another.  Each dispatch is tallied in
``kernels.tally.OP_TALLY["flash_attention"]`` on every device.  The
backward recomputes attention through the plain version and
differentiates it, as the JAX package does (it has no backward kernel):
the numbers of ``ref.py``'s gradient, with the score matrix alive only
inside the backward of one layer.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import tally
from .kernel import flash_attention_cuda
from .ref import attention_ref


def _dispatch(q, k, v, causal: bool, window: int, scale: Optional[float]):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, window, scale)
    if q.is_meta:
        return q.new_empty(q.shape)
    return attention_ref(q, k, v, causal, window, scale)


def _attend(q, k, v, causal: bool, window: int, scale: Optional[float]):
    flops, nbytes = tally.flash_work(q, k, v, causal, window)
    return tally.run("flash_attention", flops, nbytes, _dispatch, q, k, v,
                     causal, window, scale)


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
