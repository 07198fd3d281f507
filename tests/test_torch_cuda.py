"""The hand-written CUDA ``we_rounds`` kernel against its plain PyTorch
version, on the card.  Torch only (the machine with the card has no JAX):

    python -m pytest tests/test_torch_cuda.py -m gpu -q

Every test here is marked ``gpu`` and skips on a host without a CUDA
device.  ``assert_rows_agree`` is the row-level tolerance every port test
uses, and why:

* Row sums are taken in another order (a warp butterfly in the kernel,
  ATen's or XLA's reduction elsewhere), and ``log``, ``cos``, ``exp`` and
  ``sqrt`` differ between frameworks by an ulp or so; an ulp can flip a
  discrete event (the argmin finisher, ``busy``, the threshold test).
  So at least 99% of rows have equal iteration counts; on those rows
  ``t_comp`` agrees to rtol 1e-4 and ``n_comm`` to rtol 1e-3 plus one
  work unit (it sums differences of nearly equal float32 assignments,
  which cancels digits); batch means agree at 6 combined standard errors.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.we_rounds import kernel, ref

ROW_AGREE, T_RTOL, C_RTOL, C_ATOL, MEAN_SE = 0.99, 1e-4, 1e-3, 1.0, 6.0
SEED = (11, 22)


def assert_rows_agree(ours, theirs):
    """``(t_comp, iterations, n_comm)`` rows agree as the docstring says."""
    t, it, cm = (np.asarray(a, dtype=np.float64) for a in ours)
    t_r, it_r, cm_r = (np.asarray(a, dtype=np.float64) for a in theirs)
    assert t.shape == t_r.shape
    eq = it == it_r
    assert eq.mean() >= ROW_AGREE, f"only {eq.mean():.4f} of rows agree"
    np.testing.assert_allclose(t[eq], t_r[eq], rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(cm[eq], cm_r[eq], rtol=C_RTOL, atol=C_ATOL)
    se = np.hypot(t.std(), t_r.std()) / np.sqrt(t.size)
    assert abs(t.mean() - t_r.mean()) <= max(MEAN_SE * se,
                                             T_RTOL * abs(t_r.mean()))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "at the Figure 5 shape on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("Kc", [12, 56, 200])
@pytest.mark.parametrize("mode", ["known", "unknown", "drift", "panel"])
def test_cuda_kernel_matches_plain_version(cuda_device, Kc, mode):
    """Every column-per-lane instantiation (K <= 32, 64, 256), with
    zero-rate padding columns, in the four modes."""
    B = 1000
    rng = np.random.default_rng(Kc)
    lam = np.repeat(rng.uniform(10.0, 30.0, (4, Kc)), B // 4, axis=0)
    lam[:, Kc - Kc // 8:] = 0.0            # zero-rate padding columns
    lam_t = torch.from_numpy(lam.astype(np.float32)).to(cuda_device)
    n0, thr = 30_000.0, 0.01 * 30_000 / Kc
    sched = flags = None
    known = mode == "known"
    if mode == "drift":
        sched = torch.from_numpy((lam[:, None, :] * np.exp(
            0.15 * rng.standard_normal((B, 6, Kc)))).astype(
                np.float32)).to(cuda_device)
    if mode == "panel":
        flags = torch.from_numpy((np.arange(B) % 2).astype(
            np.float32)).to(cuda_device)
    kw = dict(n0=n0, threshold=thr, max_iter=10_000,
              cap=float("inf") if known else float(np.ceil(n0 / Kc)))
    before = kernel.LAUNCH_COUNTS["we_rounds"]
    got = kernel.we_rounds_cuda(lam_t, SEED, sched, flags, known=known,
                                **kw)
    torch.cuda.synchronize()
    assert kernel.LAUNCH_COUNTS["we_rounds"] == before + 1
    want = torch.stack(
        ref.we_rounds_reference_panel(lam_t, SEED, flags, sched, **kw)
        if flags is not None else
        ref.we_rounds_reference(lam_t, SEED, sched, known=known, **kw), 1)
    assert_rows_agree(got.cpu().numpy().T, want.cpu().numpy().T)


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    kw = dict(n0=1000.0, threshold=1.0, cap=float("inf"), known=True,
              max_iter=100)
    with pytest.raises(ValueError, match="K <= 256"):
        kernel.we_rounds_cuda(torch.ones(4, 257, device=cuda_device), SEED,
                              **kw)
    with pytest.raises(ValueError, match="float32"):
        kernel.we_rounds_cuda(torch.ones(4, 8, dtype=torch.float64,
                                         device=cuda_device), SEED, **kw)
    with pytest.raises(ValueError, match="one round"):
        kernel.we_rounds_cuda(torch.ones(4, 8, device=cuda_device), SEED,
                              torch.ones(4, 0, 8, device=cuda_device), **kw)
