"""The port's attention held against the JAX package.

Inputs are made with numpy from fixed seeds and go through both packages:
``repro.kernels.flash_attention`` as its own tests run it on the CPU (the
jnp oracle, the Pallas kernel in interpret mode) and
``repro.models.attention.attention_ctx`` on its direct and chunked
branches; ``repro_torch`` through its plain version, the path a CPU
tensor takes.  The CUDA kernel is held against the plain version on the
card in ``test_torch_cuda.py``.

Tolerances (as ``tests/test_kernels.py``): float32 2e-5, since softmax
sums in another order; bfloat16 2e-2, since the output rounds to 8 bits
of mantissa after fp32 arithmetic that differs in order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref as _jax_ref
from repro.models.attention import attention_ctx as _jax_attention_ctx
from repro_torch.kernels._build import LAUNCH_COUNTS
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_cuda)
from repro_torch.models.attention import attention_ctx

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# jitted: op-by-op dispatch is slower than one compilation here
jax_ref = jax.jit(_jax_ref, static_argnames=("causal", "window"))
jax_attention_ctx = jax.jit(_jax_attention_ctx,
                            static_argnames=("scale", "window"))
# (B, Sq, Sk, Hq, Hkv, d, causal, window): the table of test_kernels.py
CASES = [
    (1, 64, 64, 2, 2, 32, True, 0),
    (2, 128, 128, 4, 2, 16, True, 0),      # GQA
    (1, 64, 64, 4, 1, 32, True, 0),        # MQA
    (1, 128, 128, 2, 2, 32, True, 32),     # sliding window
    (2, 64, 64, 2, 2, 64, False, 0),       # non-causal (encoder)
    (1, 32, 128, 2, 1, 32, True, 0),       # Sq < Sk (right-aligned)
]


def qkv(B, Sq, Sk, Hq, Hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, d)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, d)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, d)).astype(np.float32))


def both(arrays, dtype):
    """The same values as torch and JAX arrays of ``dtype`` (bfloat16
    rounds to nearest even in both)."""
    return ([torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays],
            [jnp.asarray(x, getattr(jnp, dtype)) for x in arrays])


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window", CASES)
def test_plain_version_matches_jax_reference_and_kernel(
        dtype, B, Sq, Sk, Hq, Hkv, d, causal, window):
    (tq, tk, tv), (jq, jk, jv) = both(qkv(B, Sq, Sk, Hq, Hkv, d), dtype)
    ours = as_f32(attention_ref(tq, tk, tv, causal=causal, window=window))
    tol = TOL[dtype]
    want = jax_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(ours, as_f32(want), rtol=tol, atol=tol)
    kern = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                               block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(ours, as_f32(kern), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(True, 24), (False, 0)])
def test_ragged_lengths_match_jax_reference(causal, window):
    """Sq = Sk = 100, not a multiple of any block: the Pallas kernel asks
    for padding, the port's op and its CUDA kernel take it as it is."""
    (tq, tk, tv), (jq, jk, jv) = both(qkv(1, 100, 100, 4, 2, 16, seed=3),
                                      "float32")
    np.testing.assert_allclose(
        as_f32(flash_attention(tq, tk, tv, causal, window)),
        as_f32(jax_ref(jq, jk, jv, causal=causal, window=window)),
        rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("S,window", [(64, 0), (64, 16), (2100, 0),
                                      (2100, 300)])
def test_attention_ctx_matches_jax_direct_and_chunked(S, window):
    """The JAX ``attention_ctx`` takes its direct branch up to 2048
    positions and its chunked online softmax above; the port's goes to
    the flash op either way."""
    (tq, tk, tv), (jq, jk, jv) = both(qkv(1, S, S, 2, 1, 16, seed=S),
                                      "float32")
    scale = 16 ** -0.5
    np.testing.assert_allclose(
        as_f32(attention_ctx(tq, tk, tv, scale, window=window)),
        as_f32(jax_attention_ctx(jq, jk, jv, scale, window=window)),
        rtol=TOL["float32"], atol=TOL["float32"])


def test_attention_ctx_refuses_left_aligned_offsets():
    (tq, tk, tv), _ = both(qkv(1, 8, 16, 2, 1, 16), "float32")
    with pytest.raises(ValueError, match="right-aligned"):
        attention_ctx(tq, tk, tv, 0.25, q_offset=0)


def test_dispatch_by_tensor_device():
    """A CPU tensor runs the plain version; the kernel wrapper takes CUDA
    tensors only, never falls back, and counts no launch."""
    (tq, tk, tv), _ = both(qkv(1, 16, 16, 2, 1, 16), "float32")
    torch.testing.assert_close(flash_attention(tq, tk, tv, True, 4),
                               attention_ref(tq, tk, tv, True, 4),
                               rtol=0, atol=0)
    before = LAUNCH_COUNTS["flash_attention"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(tq, tk, tv)
    assert LAUNCH_COUNTS["flash_attention"] == before
