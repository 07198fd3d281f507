"""The port's differentiable kernel ops on the CPU, where each
``autograd.Function`` runs its backward formula around the plain
version: ``linear_scan`` (the reverse scan), ``flash_attention`` (the
plain recompute) and ``expert_matmul`` (two more expert products).

Each is held against autograd of its plain version, and the scan's
gradient also against the JAX package's ``jax.custom_vjp`` op run as its
own tests run it on the CPU (the Pallas kernel in interpret mode).  The
card-side gradients are in ``test_torch_cuda.py``.

Tolerances:
* the scan against autograd of its plain loop: bitwise.  The reverse
  scan makes the same rounded multiply and add per step as the loop's
  backward (one product and one sum of two terms per step), in the
  same order.
* the scan against JAX at rtol and atol 1e-4, as ``tests/test_kernels.py``
  holds the JAX op's own gradient: XLA may fuse a multiply and an add.
* attention: bitwise, since the backward is autograd of the plain version.
* the expert product: rtol and atol 1e-5 in float32 (sums of 32-64
  products in another order than the plain backward's ``bmm``), and
  3e-2 in bfloat16 (both round a float32 sum to 8 bits), as
  ``tests/test_kernels.py`` holds the forward.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.ops import linear_scan as _jax_linear_scan
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)
from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
from repro_torch.kernels.moe_gmm import expert_matmul, expert_matmul_ref


def _leaves(*arrays, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype).requires_grad_() for x in arrays]


def _grads(fn, arrays, cot, dtype=torch.float32):
    """Gradients of ``sum(fn(*inputs) * cot)`` in the inputs (fresh leaves
    of ``arrays``), and the output."""
    inputs = _leaves(*arrays, dtype=dtype)
    out = fn(*inputs)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(cot).to(
        out.dtype))
    return grads, out


def _scan_inputs(B, S, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    return a, b, g


@pytest.mark.parametrize("B,S,D", [(1, 64, 8), (2, 37, 5), (3, 1, 4)])
def test_scan_backward_is_bitwise_autograd_of_the_plain_loop(B, S, D):
    a, b, g = _scan_inputs(B, S, D, seed=S)
    (da, db), h = _grads(linear_scan, (a, b), g)
    assert h.grad_fn is not None
    (da_p, db_p), h_p = _grads(linear_scan_ref, (a, b), g)
    assert torch.equal(h, h_p)
    assert torch.equal(db, db_p)
    assert torch.equal(da, da_p)


def test_scan_gradient_matches_the_jax_op_in_interpret_mode():
    """The loss and shape of ``tests/test_kernels.py``'s VJP test:
    sum(h ** 2) over (1, 64, 8), a in (0.5, 0.99)."""
    a, b, _ = _scan_inputs(1, 64, 8, seed=0)
    jax_op = functools.partial(_jax_linear_scan, interpret=True)
    want = jax.jit(jax.grad(lambda a, b: (jax_op(a, b) ** 2).sum(),
                            argnums=(0, 1)))(a, b)
    inputs = _leaves(a, b)
    (linear_scan(*inputs) ** 2).sum().backward()
    for got, w in zip(inputs, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,d,causal,window", [
    (64, 64, 2, 1, 16, True, 0),          # tests/test_kernels.py's VJP case
    (24, 24, 4, 2, 8, True, 8),           # GQA, window
    (9, 20, 2, 2, 8, False, 0),           # Sq < Sk, non-causal
])
def test_attention_backward_is_autograd_of_the_plain_version(
        Sq, Sk, Hq, Hkv, d, causal, window):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, Hq, d)).astype(np.float32)
    k = rng.standard_normal((2, Sk, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, Sk, Hkv, d)).astype(np.float32)
    cot = rng.standard_normal((2, Sq, Hq, d)).astype(np.float32)
    got, out = _grads(lambda *x: flash_attention(*x, causal, window),
                      (q, k, v), cot)
    assert out.grad_fn is not None
    want, _ = _grads(lambda *x: attention_ref(*x, causal, window),
                     (q, k, v), cot)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("E,C,D,F", [(2, 32, 32, 32), (4, 7, 24, 40),
                                     (1, 1, 16, 8)])
def test_expert_matmul_backward_matches_autograd_of_the_plain_product(
        dtype, tol, E, C, D, F):
    rng = np.random.default_rng(C)
    buf = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    cot = rng.standard_normal((E, C, F)).astype(np.float32)
    got, out = _grads(expert_matmul, (buf, w), cot, dtype)
    assert out.grad_fn is not None and out.dtype == dtype
    want, _ = _grads(expert_matmul_ref, (buf, w), cot, dtype)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        torch.testing.assert_close(x.float(), y.float(), rtol=tol, atol=tol)

