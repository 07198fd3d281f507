"""The port's linear recurrence held against the JAX package.

Inputs are made with numpy from fixed seeds and go through both packages:
``repro.kernels.linear_scan`` as its own tests run it on the CPU (the jnp
oracle, the Pallas kernel in interpret mode) and
``repro.models.recurrent.linear_recurrence`` (an associative scan);
``repro_torch`` through its plain version, the path a CPU tensor takes.
The CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``.

Tolerance: rtol 1e-5 (atol 1e-6).  The sequential loops do the same
float32 multiply-adds in the same order, but XLA may fuse a multiply and
an add into one rounding, and the associative scan sums in another order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.ops import linear_scan as _jax_linear_scan
from repro.kernels.linear_scan.ref import linear_scan_ref as _jax_scan_ref
from repro.models.recurrent import linear_recurrence as _jax_recurrence
from repro_torch.kernels._build import LAUNCH_COUNTS
from repro_torch.kernels.linear_scan import (linear_scan, linear_scan_cuda,
                                             linear_scan_ref)
from repro_torch.models.recurrent import linear_recurrence

RTOL, ATOL = 1e-5, 1e-6
# jitted: op-by-op dispatch of the associative scan alone takes seconds
jax_scan_ref = jax.jit(_jax_scan_ref)
jax_recurrence = jax.jit(_jax_recurrence)
jax_linear_scan = jax.jit(functools.partial(_jax_linear_scan,
                                            interpret=True))


def coeffs(B, S, D, seed=0):
    """RG-LRU-like coefficients: a in (0.5, 1), b ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    return a, b


def port(fn, *arrays):
    return fn(*(torch.from_numpy(x) for x in arrays)).numpy()


@pytest.mark.parametrize("B,S,D", [(2, 64, 32), (3, 256, 8)])
def test_plain_version_matches_jax_reference_and_kernel(B, S, D):
    a, b = coeffs(B, S, D, seed=S)
    ours = port(linear_scan_ref, a, b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(ours, np.asarray(jax_scan_ref(ja, jb)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ours, np.asarray(jax_linear_scan(ja, jb)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port(linear_recurrence, a, b),
                               np.asarray(jax_recurrence(ja, jb)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", [1, 300, 1001])
def test_ragged_length_matches_jax_reference(S):
    """S not a multiple of the Pallas chunk (256): the JAX kernel asks for
    padding; the port's op and its kernel take any S."""
    a, b = coeffs(2, S, 24, seed=S)
    np.testing.assert_allclose(
        port(linear_scan, a, b),
        np.asarray(jax_scan_ref(jnp.asarray(a), jnp.asarray(b))),
        rtol=RTOL, atol=ATOL)


def test_dispatch_by_tensor_device():
    """A CPU tensor runs the plain version; the kernel wrapper takes CUDA
    tensors only, never falls back, and counts no launch."""
    a, b = (torch.from_numpy(x) for x in coeffs(2, 33, 8))
    torch.testing.assert_close(linear_scan(a, b), linear_scan_ref(a, b),
                               rtol=0, atol=0)
    before = LAUNCH_COUNTS["linear_scan"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        linear_scan_cuda(a, b)
    assert LAUNCH_COUNTS["linear_scan"] == before
