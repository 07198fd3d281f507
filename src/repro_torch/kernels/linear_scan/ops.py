"""The differentiable linear recurrence: the port of the JAX package's
``jax.custom_vjp`` op (``repro.kernels.linear_scan.ops``).

Backward of h_t = a_t h_{t-1} + b_t:
    db_t = g_t + a_{t+1} db_{t+1}      (a reverse linear scan)
    da_t = db_t * h_{t-1}
so the backward runs the SAME scan on reversed inputs.  Every scan, the
forward's and the backward's, dispatches by device: a CUDA tensor
launches the hand-written kernel, a CPU tensor runs the plain version, a
``meta`` tensor makes the kernel's output (``torch.empty`` like ``a``).
Nothing falls back from one to another, so the CPU runs the same
backward formula around the plain scan, which is how the tests hold the
formula against autograd of the plain loop.  Each scan is tallied in
``kernels.tally.OP_TALLY["linear_scan"]`` on every device.
"""
from __future__ import annotations

import torch

from .. import tally
from .kernel import linear_scan_cuda
from .ref import linear_scan_ref


def _dispatch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return linear_scan_cuda(a, b)
    if a.is_meta:
        return a.new_empty(a.shape)
    return linear_scan_ref(a, b)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    flops, nbytes = tally.scan_work(a, b)
    return tally.run("linear_scan", flops, nbytes, _dispatch, a, b)


class LinearScan(torch.autograd.Function):
    """h = scan(a, b) with the reverse-scan backward; saves a and h."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, h = ctx.saved_tensors
        zero = a.new_zeros((a.shape[0], 1, a.shape[2]))
        a_next = torch.cat([a[:, 1:], zero], dim=1)
        # flip makes fresh contiguous copies: the kernel takes contiguous
        # float32, and a fresh allocation starts on a 16-byte boundary, so
        # the backward launch takes the same design as the forward's
        db = _scan(a_next.flip(1), g.flip(1).contiguous()).flip(1)
        h_prev = torch.cat([zero, h[:, :-1]], dim=1)
        return db * h_prev, db


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) float32. Returns h with h_t = a_t h_{t-1} + b_t,
    h_0 = b_0; differentiable in a and b."""
    return LinearScan.apply(a, b)
