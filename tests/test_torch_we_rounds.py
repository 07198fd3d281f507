"""The port's ``we_rounds`` pipeline held against the JAX reference.

Inputs are made with numpy from fixed seeds and go through both packages:
``repro.kernels.we_rounds`` runs as its own tests run it on the CPU (the
jitted jnp reference), ``repro_torch.kernels.we_rounds`` runs its plain
PyTorch version (the dispatch a CPU tensor takes).  The CUDA kernel is
held against the plain version on the card in ``test_torch_cuda.py``.

Tolerances, and why:

* Threefry words and ``uniform01`` are integer math and a 24-bit
  conversion: bitwise equal.
* ``log``, ``cos``, ``exp`` and ``sqrt`` differ between XLA and ATen by an
  ulp or so, so single variates agree to a few float32 ulp (rtol 1e-6);
  the boosted Gamma carries ``exp`` of a sum of logs, whose relative error
  grows with the exponent's magnitude (rtol 1e-5).
* Whole rows: ``assert_rows_agree`` of ``test_torch_cuda.py`` (>= 99% of
  rows with equal iterations, ``t_comp`` rtol 1e-4 and ``n_comm`` rtol
  1e-3 on them, means at 6 SE), with the reasons given there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.we_rounds import gamma_rows_grid as jax_gamma_rows_grid
from repro.kernels.we_rounds import ref as jref
from repro.kernels.we_rounds import we_rounds_grid as jax_we_rounds_grid
from repro_torch.kernels.we_rounds import (gamma_rows_grid, kernel, ref,
                                           we_rounds, we_rounds_grid)

from test_torch_cuda import assert_rows_agree

K, N = 12, 30_000
THRESHOLD = 0.01 * N / K
SEED = (11, 22)


def lam_rows(B, seed=3):
    rng = np.random.default_rng(seed)
    return np.repeat(rng.uniform(10.0, 30.0, size=(1, K)), B, axis=0)


def run_both(B, known=True, sched=None):
    """Port (CPU) and JAX reference on the same rows, seed and config."""
    cap = np.inf if known is True else float(np.ceil(N / K))
    kw = dict(n0=N, threshold=THRESHOLD, cap=cap, known=known,
              max_iter=10_000, rate_schedule=sched)
    return (we_rounds_grid(lam_rows(B), SEED, device="cpu", **kw),
            jax_we_rounds_grid(lam_rows(B), SEED, mode="reference", **kw))


@functools.lru_cache(maxsize=None)
def run_both_cached(B, known):
    """``run_both`` without a schedule, computed once per test process
    (each new JAX shape or config is a fresh compilation)."""
    return run_both(B, known)


# ---------------------------------------------------------------------------
# bits and variates
# ---------------------------------------------------------------------------

COUNTERS = np.concatenate([
    [0, 0xFFFFFFFF, 1, 0x80000000],
    np.random.default_rng(0).integers(0, 2 ** 32, 124)]).astype(np.uint32)


@pytest.mark.parametrize("k0,k1", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                   (0, 0xFFFFFFFF), (11, 22),
                                   (0x1BD11BDA, 987654321)])
def test_threefry_words_bitwise(k0, k1):
    """uint32 Threefry-2x32 in masked int64 torch equals the reference's
    words bit for bit (torch on the CPU has no uint32 add or shifts)."""
    c0 = COUNTERS[:, None]
    c1 = COUNTERS[::-1][None, :]
    want = jref.threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                             jnp.asarray(c0), jnp.asarray(c1))
    got = ref.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                           torch.from_numpy(c1.astype(np.int64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


def _words(n=4096, seed=1):
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, n,
                                                dtype=np.uint32)
    bits[:3] = (0, 0xFF, 0xFFFFFFFF)   # below 2**8 -> the 1e-12 floor
    return bits


def test_uniform01_exact():
    bits = _words()
    got = ref.uniform01(torch.from_numpy(bits.astype(np.int64)))
    want = np.asarray(jref.uniform01(jnp.asarray(bits)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _variates(n=4096):
    rng = np.random.default_rng(2)
    u = rng.uniform(1e-7, 1.0, size=(6, n)).astype(np.float32)
    return u, [torch.from_numpy(x) for x in u], [jnp.asarray(x) for x in u]


def test_box_muller_within_ulps():
    _, t, j = _variates()
    np.testing.assert_allclose(ref._box_muller(t[0], t[1]).numpy(),
                               np.asarray(jref._box_muller(j[0], j[1])),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lo,hi,rtol", [(3.0, 5000.0, 1e-6),
                                        (0.5, 3.0, 1e-5)])
def test_gamma_mt_within_ulps(lo, hi, rtol):
    """Large shapes (no boost) to a few ulp; the boosted branch adds
    ``exp`` of a sum of logs, hence the wider rtol."""
    u, t, j = _variates()
    alpha = np.random.default_rng(3).uniform(lo, hi, u.shape[1]).astype(
        np.float32)
    inv = np.random.default_rng(4).uniform(0.01, 0.1, u.shape[1]).astype(
        np.float32)
    z_t = ref._box_muller(t[0], t[1])
    z_j = jref._box_muller(j[0], j[1])
    got = ref.gamma_mt(z_t, t[2], t[3], t[4], torch.from_numpy(alpha),
                       torch.from_numpy(inv))
    want = jref.gamma_mt(z_j, j[2], j[3], j[4], jnp.asarray(alpha),
                         jnp.asarray(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-6)


def test_binomial_normal_within_ulps():
    u, t, j = _variates()
    n = np.floor(np.random.default_rng(5).uniform(0, 3000, u.shape[1]))
    n = n.astype(np.float32)
    got = ref.binomial_normal(ref._box_muller(t[0], t[1]),
                              torch.from_numpy(n), t[5])
    want = jref.binomial_normal(jref._box_muller(j[0], j[1]),
                                jnp.asarray(n), j[5])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# whole rows against repro.kernels.we_rounds.we_rounds_grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("known", [True, False])
def test_rows_match_reference(known):
    ours, theirs = run_both_cached(256, known)
    assert_rows_agree(ours, theirs)
    assert (ours[1] >= 1).all() and np.isfinite(ours[0]).all()


def test_drift_rows_match_reference():
    """The per-round schedule re-scales the Gamma draws only; rows still
    agree, and the schedule really changes the outcome (unknown rates:
    the estimator is what drift stresses)."""
    B, known = 256, False
    sched = (lam_rows(B)[:, None, :] * np.exp(
        0.15 * np.random.default_rng(17).standard_normal((B, 6, K))))
    ours, theirs = run_both(B, known, sched)
    assert_rows_agree(ours, theirs)
    plain, _ = run_both_cached(B, known)
    assert not np.array_equal(ours[0], plain[0])


def test_panel_rows_match_reference():
    """Mixed panel: per-row known flags (known rows uncapped)."""
    flags = np.arange(256) % 3 == 0
    ours, theirs = run_both(256, flags.astype(np.float32))
    assert_rows_agree(ours, theirs)
    for sel in (flags, ~flags):
        # each half agrees with its single-mode run at the same row ids
        single, _ = run_both_cached(256, bool(sel[0]))
        np.testing.assert_allclose(ours[0][sel], single[0][sel], rtol=0)


@pytest.mark.parametrize("B", [1, 77, 130])
def test_odd_batches_pad_without_perturbing(B):
    """Odd batches pad with copies of row 0; real rows equal the first B
    rows of a larger run (counters are keyed by the global row id), and
    the outputs keep the requested length."""
    cap = np.inf
    ours = we_rounds_grid(lam_rows(B), SEED, device="cpu", n0=N,
                          threshold=THRESHOLD, cap=cap, known=True,
                          max_iter=10_000)
    big, theirs = run_both_cached(256, True)
    assert ours[0].shape == ours[1].shape == ours[2].shape == (B,)
    for a, b in zip(ours, big):
        np.testing.assert_array_equal(a, b[:B])
    assert_rows_agree(ours, tuple(a[:B] for a in theirs))


@pytest.mark.parametrize("shape_lo", [0.5, 3.0])
def test_gamma_rows_match_reference(shape_lo):
    rng = np.random.default_rng(6)
    shape = rng.uniform(shape_lo, 40.0, size=(300, 1))
    scale = rng.uniform(0.01, 0.1, size=(1, 8))
    got = gamma_rows_grid(shape, scale, (5, 6), device="cpu")
    want = jax_gamma_rows_grid(shape, scale, (5, 6))
    assert got.dtype == np.float32 and got.shape == (300, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_gamma_rows_moments():
    """Counter-based MT gamma rows: mean exact, variance alpha + 1/9
    (large-shape transform) at 6 SE."""
    R, Kc, alpha, scale = 4096, 8, 7.5, 0.5
    g = gamma_rows_grid(np.full((R, Kc), alpha), np.full((R, Kc), scale),
                        (1, 2), device="cpu")
    se_mean = np.sqrt(alpha + 1 / 9) * scale / np.sqrt(R * Kc)
    assert abs(g.mean() - alpha * scale) < 6 * se_mean
    var_want = (alpha + 1 / 9) * scale ** 2
    assert abs(g.var() - var_want) < 0.05 * var_want


def test_dispatch_by_tensor_device():
    """A CPU tensor runs the plain version; the kernel wrapper takes CUDA
    tensors only and never falls back."""
    lam = torch.from_numpy(lam_rows(8).astype(np.float32))
    kw = dict(n0=float(N), threshold=THRESHOLD, cap=float("inf"),
              known=True, max_iter=10_000)
    out = we_rounds(lam, SEED, **kw)
    cols = ref.we_rounds_reference(lam, SEED, **kw)
    torch.testing.assert_close(out, torch.stack(cols, 1), rtol=0, atol=0)
    before = kernel.LAUNCH_COUNTS["we_rounds"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.we_rounds_cuda(lam, SEED, **kw)
    assert kernel.LAUNCH_COUNTS["we_rounds"] == before


def test_build_library_is_keyed_by_source_hash():
    """The built library's name carries a hash of the source and the
    flags, in a build directory that git ignores."""
    path = kernel.library_path()
    assert path.parent == kernel.BUILD_DIR
    assert path.name.startswith("we_rounds-") and path.suffix == ".so"
    assert "--use_fast_math" not in kernel.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
    assert "src/repro_torch/_build/" in (
        kernel.BUILD_DIR.parents[2] / ".gitignore").read_text()
