"""The hand-written CUDA kernels (``we_rounds``, ``linear_scan``,
``flash_attention``, ``expert_matmul``) against their plain PyTorch
versions, on the card, and the serving slices' kernel paths against their
CPU paths.  Torch only
(the machine with the card has no JAX):

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

``we_rounds`` is also held bit for bit (``test_cuda_kernel_is_bitwise_
plain_version``): on the card the plain version makes the same float32
operations in the same order, its row sums in the kernel's lane order.

``linear_scan`` is bitwise equal to its plain version: the same float32
multiply and add per step, in the same order, each rounded (the kernel is
built with ``--fmad=false``), in both designs ("ring", TMA-fed, for D a
multiple of 4 on 16-byte aligned pointers; "direct" for the rest).
``flash_attention`` agrees to 2e-5 in
float32 and 2e-2 in bfloat16 (as ``tests/test_kernels.py``): the online
softmax sums in another order, and bfloat16 output rounds to 8 bits.
``expert_matmul`` agrees to 1e-5 in float32 and 3e-2 in bfloat16, as
``tests/test_kernels.py`` holds the Pallas kernel: both accumulate in
float32, in another order; the inputs are scaled as the model's (w by
D^-1/2), so outputs are O(1) and 1e-5 is some 80 float32 ulps.

Both kernels have two designs, picked by the wrapper before it launches:
bfloat16 takes the tensor cores ("tc"), float32 (and bfloat16 expert
products whose D or F is no multiple of 8) the FMA units ("fma");
``DESIGN_COUNTS`` shows which.  The tensor-core designs sum in one fixed
order, so two launches on the same inputs give the same bits.
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import UnitStore, structured_unit
from repro_torch.hettrain import ScanGradEngine
from repro_torch.kernels._build import (DESIGN_COUNTS, LAUNCH_COUNTS,
                                        reset_launch_counts)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_design)
from repro_torch.kernels.linear_scan import (linear_scan, linear_scan_cuda,
                                             linear_scan_design,
                                             linear_scan_ref)
from repro_torch.kernels.moe_gmm import (expert_matmul, expert_matmul_cuda,
                                         expert_matmul_design,
                                         expert_matmul_ref)
from repro_torch.kernels.we_rounds import kernel, ref
from repro_torch.models import build_model, moe
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.loop import make_grad_step

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
@pytest.mark.parametrize("K", [1, 31, 32, 33, 56, 64, 65, 256])
@pytest.mark.parametrize("mode", ["known", "unknown", "drift", "panel"])
def test_cuda_kernel_is_bitwise_plain_version(cuda_device, K, mode):
    """Bit for bit: the kernel and the plain version make the same
    Threefry words and the same float32 operations in the same order, row
    sums included (``ref.lane_sum`` repeats the kernel's lanes and
    butterfly).  Odd B, every column-per-lane instantiation and its edges,
    zero-rate padding columns."""
    B = 333
    rng = np.random.default_rng(K)
    lam = rng.uniform(5.0, 40.0, (B, K)).astype(np.float32)
    lam[:, K - K // 8:] = 0.0              # zero-rate padding columns
    lam_t = torch.from_numpy(lam).to(cuda_device)
    n0 = 20_000.0
    known = mode == "known"
    sched = flags = None
    if mode == "drift":
        sched = torch.from_numpy((lam[:, None, :] * np.exp(
            0.2 * rng.standard_normal((B, 5, K)))).astype(
                np.float32)).to(cuda_device)
    if mode == "panel":
        flags = torch.from_numpy((np.arange(B) % 3 == 0).astype(
            np.float32)).to(cuda_device)
    kw = dict(n0=n0, threshold=0.01 * n0 / K, max_iter=10_000,
              cap=float("inf") if known else float(np.ceil(n0 / K)))
    got = kernel.we_rounds_cuda(lam_t, SEED, sched, flags, known=known,
                                **kw)
    want = torch.stack(
        ref.we_rounds_reference_panel(lam_t, SEED, flags, sched, **kw)
        if flags is not None else
        ref.we_rounds_reference(lam_t, SEED, sched, known=known, **kw), 1)
    torch.cuda.synchronize()
    assert bool((got[:, 1] >= 1).all())
    assert torch.equal(got, want), float((got - want).abs().max())


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


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D", [(3, 1001, 96), (2, 64, 2560),
                                   (1, 17, 1)])
def test_linear_scan_kernel_is_bitwise_plain_version(cuda_device, B, S, D):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, D)).astype(
        np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32)).to(cuda_device)
    before = LAUNCH_COUNTS["linear_scan"]
    got = linear_scan_cuda(a, b)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["linear_scan"] == before + 1
    torch.testing.assert_close(got, linear_scan_ref(a, b), rtol=0, atol=0)


RING_STEPS = 64     # the ring design's stage length (kSteps in the source)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, RING_STEPS - 1, RING_STEPS,
                               RING_STEPS + 1, 1001, 3000])
@pytest.mark.parametrize("D", [1, 31, 33, 96, 100, 2560])
@pytest.mark.parametrize("B", [1, 4])
def test_linear_scan_designs_are_bitwise_plain_version(cuda_device, B, D,
                                                       S):
    """Both designs (ring: D a multiple of 4; direct: the rest, and a
    pointer off 16 bytes) over ragged channel tiles and stages; each
    launch takes the design ``linear_scan_design`` names."""
    rng = np.random.default_rng(B * 7919 + D * 31 + S)
    a_np = rng.uniform(0.5, 1.0, (B, S, D)).astype(np.float32)
    b_np = rng.standard_normal((B, S, D)).astype(np.float32)
    a, b = (torch.from_numpy(x).to(cuda_device) for x in (a_np, b_np))
    # the same values one float past a 16-byte boundary
    a_off, b_off = (torch.cat([torch.zeros(1, device=cuda_device),
                               x.flatten()])[1:].view(B, S, D)
                    for x in (a, b))
    want = linear_scan_ref(a, b)
    for x, y, aligned in ((a, b, True), (a_off, b_off, False)):
        design = linear_scan_design(D, aligned)
        reset_launch_counts()
        got = linear_scan_cuda(x, y)
        torch.cuda.synchronize()
        assert {k: n for k, n in DESIGN_COUNTS.items() if n} == {
            ("linear_scan", design): 1}
        assert LAUNCH_COUNTS["linear_scan"] == 1
        assert torch.equal(got, want), (design, float(
            (got - want).abs().max()))


FLASH_CASES = [
    # (B, Sq, Sk, Hq, Hkv, d, causal, window)
    (1, 64, 64, 2, 2, 16, True, 0),
    (2, 128, 128, 4, 2, 32, True, 0),        # GQA, g = 2
    (1, 100, 100, 10, 1, 256, True, 24),     # MQA, window, ragged
    (2, 64, 64, 2, 2, 64, False, 0),         # non-causal
    (1, 32, 130, 2, 1, 128, True, 0),        # Sq < Sk, right-aligned
    (1, 1000, 1000, 4, 2, 64, True, 300),    # ragged Sq = Sk = 1000
    (1, 1000, 1000, 2, 1, 128, False, 200),  # non-causal with a window
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda_device, dtype, tol, B, Sq,
                                            Sk, Hq, Hkv, d, causal, window):
    rng = np.random.default_rng(Sq + d)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    q, k, v = draw(B, Sq, Hq, d), draw(B, Sk, Hkv, d), draw(B, Sk, Hkv, d)
    before = LAUNCH_COUNTS["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# bf16 edges of the tensor-core design's tiles (64 query rows, 64 keys, 32
# at d 256): Sq and Sk no multiple of a tile, windows no multiple of a
# key tile, Sq < Sk and Sq > Sk (rows that see no key give 0)
FLASH_EDGES = [
    (1, 77, 190, 4, 2, 64, True, 50),
    (2, 190, 77, 2, 1, 32, True, 0),
    (1, 300, 333, 10, 1, 256, True, 100),
    (1, 257, 257, 3, 3, 16, False, 0),
    (1, 129, 200, 2, 2, 128, False, 70),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window", FLASH_EDGES)
def test_flash_tensor_core_edges_match_plain_and_repeat_bitwise(
        cuda_device, B, Sq, Sk, Hq, Hkv, d, causal, window):
    gen = torch.Generator(device=cuda_device).manual_seed(Sq * Sk + d)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(
            torch.bfloat16)

    q, k, v = draw(B, Sq, Hq, d), draw(B, Sk, Hkv, d), draw(B, Sk, Hkv, d)
    before = DESIGN_COUNTS[("flash_attention", "tc")]
    got = flash_attention_cuda(q, k, v, causal, window)
    again = flash_attention_cuda(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert DESIGN_COUNTS[("flash_attention", "tc")] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal, window).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_new_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.ones(1, 8, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(x, x, x)
    h = torch.ones(1, 8, 2, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(h, h, h)
    q = torch.ones(1, 8, 3, 16, device=cuda_device)
    kv = torch.ones(1, 8, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_cuda(q, kv, kv)
    m = torch.ones(257, device=cuda_device, dtype=torch.bfloat16)[1:]
    m = m.view(1, 8, 2, 16)                  # 2 bytes off a 16-byte line
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(m, m, m)
    a = torch.ones(2, 5, 3, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        linear_scan_cuda(a, a)


GMM_CASES = [
    # (E, C, D, F): ragged edges in every dimension, then granite's
    # decode, prefill gate/up and prefill down shapes
    (1, 1, 24, 96), (3, 7, 200, 24), (8, 130, 96, 200), (2, 17, 1, 5),
    (40, 8, 1536, 512), (40, 2000, 1536, 512), (40, 2000, 512, 1536),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("E,C,D,F", GMM_CASES)
def test_expert_matmul_kernel_matches_plain_version(cuda_device, dtype, tol,
                                                    E, C, D, F):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(E * C + D + F)
    buf = torch.randn((E, C, D), generator=gen, device=cuda_device
                      ).to(dtype)
    w = (torch.randn((E, D, F), generator=gen, device=cuda_device)
         * D ** -0.5).to(dtype)
    before = LAUNCH_COUNTS["expert_matmul"]
    got = expert_matmul_cuda(buf, w)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["expert_matmul"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (E, C, F)
    torch.testing.assert_close(got.float(),
                               expert_matmul_ref(buf, w).float(),
                               rtol=tol, atol=tol)


# bf16 edges of the tensor-core design: C of 1, 8, 16 (16-row decode
# tiles) and 17, 200 (no multiple of the 128-row prefill tile); D no
# multiple of the 64-deep slab; F no multiple of the 64- or 128-column tile
GMM_EDGES = [(4, 1, 40, 72), (4, 8, 200, 136), (4, 16, 72, 24),
             (4, 17, 200, 136), (3, 200, 1000, 264), (2, 130, 72, 520)]


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,D,F", GMM_EDGES)
def test_expert_matmul_tensor_core_edges_match_plain_and_repeat_bitwise(
        cuda_device, E, C, D, F):
    gen = torch.Generator(device=cuda_device).manual_seed(E * C + D + F)
    buf = torch.randn((E, C, D), generator=gen, device=cuda_device
                      ).to(torch.bfloat16)
    w = (torch.randn((E, D, F), generator=gen, device=cuda_device)
         * D ** -0.5).to(torch.bfloat16)
    before = DESIGN_COUNTS[("expert_matmul", "tc")]
    got = expert_matmul_cuda(buf, w)
    again = expert_matmul_cuda(buf, w)
    torch.cuda.synchronize()
    assert DESIGN_COUNTS[("expert_matmul", "tc")] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), expert_matmul_ref(buf, w).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,F,design", [
    (torch.bfloat16, 96, 200, "tc"), (torch.float32, 96, 200, "fma"),
    (torch.bfloat16, 1, 5, "fma"), (torch.bfloat16, 100, 16, "fma"),
    (torch.bfloat16, 96, 20, "fma")])
def test_each_launch_counts_the_design_it_took(cuda_device, dtype, D, F,
                                               design):
    """bf16 with D and F multiples of 8 takes the tensor cores; float32,
    and bf16 with D or F no multiple of 8, the FMA units; flash follows
    the dtype alone.  Both agree with the plain versions either way."""
    assert expert_matmul_design(dtype, D, F) == design
    buf = torch.randn((2, 20, D), device=cuda_device).to(dtype)
    w = (torch.randn((2, D, F), device=cuda_device) * D ** -0.5).to(dtype)
    reset_launch_counts()
    got = expert_matmul_cuda(buf, w)
    q = torch.randn((1, 70, 2, 64), device=cuda_device).to(dtype)
    o = flash_attention_cuda(q, q, q)
    torch.cuda.synchronize()
    flash = flash_attention_design(dtype, 64)
    assert flash == ("tc" if dtype == torch.bfloat16 else "fma")
    assert {k: n for k, n in DESIGN_COUNTS.items() if n} == {
        ("expert_matmul", design): 1, ("flash_attention", flash): 1}
    assert LAUNCH_COUNTS["expert_matmul"] == LAUNCH_COUNTS[
        "flash_attention"] == 1
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), expert_matmul_ref(buf, w).float(),
                               rtol=tol, atol=tol)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), attention_ref(q, q, q).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_expert_matmul_rejects_what_it_does_not_take(cuda_device):
    buf = torch.ones(2, 8, 16, device=cuda_device)
    w = torch.ones(2, 16, 4, device=cuda_device)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        expert_matmul_cuda(buf.cpu(), w.cpu())
    with pytest.raises(ValueError, match="w must be float32"):
        expert_matmul_cuda(buf, w.bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        expert_matmul_cuda(buf.half(), w.half())
    with pytest.raises(ValueError, match=r"\(E, C, D\)"):
        expert_matmul_cuda(buf[0], w)
    with pytest.raises(ValueError, match="contiguous"):
        expert_matmul_cuda(buf.transpose(1, 2).contiguous().transpose(1, 2),
                           w)
    with pytest.raises(ValueError, match="shape"):
        expert_matmul_cuda(buf, torch.ones(3, 16, 4, device=cuda_device))
    with pytest.raises(ValueError, match="shape"):
        expert_matmul_cuda(buf, torch.ones(2, 15, 4, device=cuda_device))
    with pytest.raises(ValueError, match="must be on"):
        expert_matmul_cuda(buf, w.cpu())


@pytest.mark.gpu
def test_moe_serve_path_on_the_card_runs_the_kernels(cuda_device):
    """The granite-moe smoke model in float32: prefill and two decode
    steps on the card launch flash attention once per layer at prefill
    and the expert kernel three times per layer per call, and agree with
    the same weights on the CPU at rtol and atol 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        smoke_config(get_config("granite-moe-3b-a800m")), dtype="float32")
    m = build_model(cfg)
    params = m.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)))
    outs = {}
    for dev, p in (("cpu", params), (cuda_device, _to(params, cuda_device))):
        reset_launch_counts()
        cache = m.init_cache(2, 24, dev)
        logits, cache = m.prefill(p, {"tokens": toks.to(dev)}, cache)
        steps = [logits]
        for t in range(2):
            logits, cache = m.decode_step(p, cache, toks[:, t:t + 1].to(dev))
            steps.append(logits)
        outs[str(dev)] = torch.cat(steps, 1).cpu()
        counts = dict(LAUNCH_COUNTS)
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["expert_matmul"] == 3 * 3 * cfg.n_layers
    torch.testing.assert_close(outs[str(cuda_device)], outs["cpu"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_serve_path_on_the_card_runs_the_kernels(cuda_device):
    """The recurrentgemma smoke model in float32: prefill and decode on
    the card launch one kernel per layer of each kind and agree with the
    same weights on the CPU (float32 matrix products stay full float32 on
    the card by default) at rtol and atol 1e-4."""
    cfg = dataclasses.replace(smoke_config(get_config("recurrentgemma-2b")),
                              dtype="float32")
    m = build_model(cfg)
    params = m.init(0, "cpu")
    gpu_params = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)))
    outs = {}
    for dev, p in (("cpu", params), (cuda_device, gpu_params)):
        reset_launch_counts()
        cache = m.init_cache(2, 24, dev)
        logits, cache = m.prefill(p, {"tokens": toks.to(dev)}, cache)
        steps = [logits]
        for t in range(2):
            logits, cache = m.decode_step(p, cache, toks[:, t:t + 1].to(dev))
            steps.append(logits)
        outs[str(dev)] = torch.cat(steps, 1).cpu()
        counts = dict(LAUNCH_COUNTS)
    assert counts["flash_attention"] == 2 and counts["linear_scan"] == 4
    assert DESIGN_COUNTS[("linear_scan", "ring")] == 4     # lru_width 64
    torch.testing.assert_close(outs[str(cuda_device)], outs["cpu"],
                               rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# gradients through the kernel ops, and the training step
# ---------------------------------------------------------------------------

def _op_cases(dev):
    """(name, op, plain version, inputs, kernel launches its backward
    makes) at the shapes of ``tests/test_kernels.py``'s VJP tests (the
    expert product at its first forward case), float32."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    a = torch.rand((1, 64, 8), generator=gen, device=dev) * 0.49 + 0.5
    return [
        ("linear_scan", linear_scan, linear_scan_ref,
         (a, draw(1, 64, 8)), 1),
        ("flash_attention", flash_attention, attention_ref,
         (draw(1, 64, 2, 16), draw(1, 64, 1, 16), draw(1, 64, 1, 16)), 0),
        ("expert_matmul", expert_matmul, expert_matmul_ref,
         (draw(2, 32, 32), draw(2, 32, 32) * 32 ** -0.5), 2),
    ]


@pytest.mark.gpu
def test_kernel_ops_carry_gradients_on_the_card(cuda_device):
    """A CUDA output of each op has a ``grad_fn``, and ``backward`` fills
    ``.grad`` of every input; the scan's backward launches the kernel
    once more (on the ring), the expert product's twice, attention's
    none (it recomputes through the plain version)."""
    for name, op, _, inputs, bwd_launches in _op_cases(cuda_device):
        leaves = [x.clone().requires_grad_() for x in inputs]
        out = op(*leaves)
        assert out.grad_fn is not None, name
        reset_launch_counts()
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS[name] == bwd_launches, name
        if name == "linear_scan":
            assert DESIGN_COUNTS[("linear_scan", "ring")] == 1
        for x in leaves:
            assert x.grad is not None and x.grad.shape == x.shape, name
            assert bool(torch.isfinite(x.grad).all()), name


@pytest.mark.gpu
def test_kernel_op_gradients_match_autograd_of_the_plain_version(
        cuda_device):
    """sum(out ** 2)'s gradients at 1e-4, as ``tests/test_kernels.py``
    holds the JAX ops' (the forwards differ by their own tolerances)."""
    for name, op, plain, inputs, _ in _op_cases(cuda_device):
        got, want = ([x.clone().requires_grad_() for x in inputs]
                     for _ in range(2))
        (op(*got) ** 2).sum().backward()
        (plain(*want) ** 2).sum().backward()
        for x, y in zip(got, want):
            torch.testing.assert_close(x.grad, y.grad, rtol=1e-4,
                                       atol=1e-4, msg=name)


@pytest.mark.gpu
def test_train_step_on_the_card_runs_the_kernels_and_matches_cpu(
        cuda_device):
    """The recurrentgemma smoke model in float32 (two (rec, rec, attn)
    periods): one remat gradient step on the card against the same
    weights on the CPU at rtol and atol 1e-4, as the CPU path is held to
    JAX.  Launches: attention 2 forward + 2 recomputed; the scan 4
    forward + 4 recomputed + 4 backward, all on the ring."""
    cfg = dataclasses.replace(smoke_config(get_config("recurrentgemma-2b")),
                              dtype="float32")
    m = build_model(cfg)
    params = m.init(0, "cpu")
    batch = structured_unit(0, 2, 40, cfg.vocab_size)
    step = make_grad_step(m, remat=True)
    loss_c, grads_c = step(params, batch)
    reset_launch_counts()
    loss_g, grads_g = step(_to(params, cuda_device), batch)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention"] == 4
    assert LAUNCH_COUNTS["linear_scan"] == 12
    assert DESIGN_COUNTS[("linear_scan", "ring")] == 12
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4, atol=1e-4)
    for x, y in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_moe_layer_backward_takes_six_tensor_core_launches(cuda_device):
    """One MoE layer of the granite-moe smoke config in bfloat16 (D and F
    multiples of 8): its backward launches the expert kernel six times
    (two for each of the three products), all on the tensor cores, and
    fills ``.grad`` of x and of every weight, the float32 router too."""
    cfg = dataclasses.replace(
        smoke_config(get_config("granite-moe-3b-a800m")), dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    layer = {k: v.requires_grad_() for k, v in moe.moe_init(
        gen, cfg, torch.bfloat16, cuda_device).items()}
    x = torch.randn((2, 24, cfg.d_model), generator=gen,
                    device=cuda_device).bfloat16().requires_grad_()
    out, aux = moe.moe_apply(layer, cfg, x)
    assert out.grad_fn is not None
    reset_launch_counts()
    ((out.float() ** 2).sum() + aux).backward()
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["expert_matmul"] == 6
    assert DESIGN_COUNTS[("expert_matmul", "tc")] == 6
    for t in [x, *layer.values()]:
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all())
        assert bool((t.grad != 0).any())


@pytest.mark.gpu
def test_engine_sums_are_order_invariant_on_the_card(cuda_device):
    """The unit-group gradient engine on the granite-moe smoke config in
    bfloat16: a group's float32 sum and losses are bitwise equal whichever
    order its ids come in, and each unit launches flash once and the
    expert kernel nine times a layer (no remat)."""
    cfg = dataclasses.replace(
        smoke_config(get_config("granite-moe-3b-a800m")), dtype="bfloat16")
    m = build_model(cfg)
    params = m.init(0, cuda_device)
    engine = ScanGradEngine(m, UnitStore(2, 16, cfg.vocab_size,
                                         structured=True))
    reset_launch_counts()
    a, la = engine.grad_sum(params, [3, 1, 0, 2])
    b, lb = engine.grad_sum(params, [0, 1, 2, 3])
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention"] == 8 * cfg.n_layers
    assert LAUNCH_COUNTS["expert_matmul"] == 8 * 9 * cfg.n_layers
    assert np.array_equal(la, lb) and np.all(np.isfinite(la))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == torch.float32 and x.is_cuda
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_het_trainer_is_bitwise_across_policies_on_the_card(cuda_device):
    """``HetTrainer`` on the recurrentgemma smoke config in bfloat16, on
    the card: two steps of 8 units under each of the five policies, each
    from the same seeded weights, end on bitwise equal parameters, and a
    step launches 8 x a unit's kernels (flash once a local-attention
    layer, the scan twice an RG-LRU layer; no remat)."""
    from repro_torch.distributed import POLICIES, HetTrainer
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(smoke_config(get_config("recurrentgemma-2b")),
                              dtype="bfloat16")
    m = build_model(cfg)
    store = UnitStore(1, 32, cfg.vocab_size, structured=True)
    kinds = cfg.layer_kinds()
    finals = []
    for policy in POLICIES:
        trainer = HetTrainer(m, AdamW(lr=1e-3), [1.0, 4.0, 2.0, 8.0], store,
                             policy=policy, units_per_step=8)
        reset_launch_counts()
        params, _, hist = trainer.train(m.init(0, cuda_device), 2)
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS["flash_attention"] == 2 * 8 * kinds.count("attn")
        assert LAUNCH_COUNTS["linear_scan"] == 2 * 8 * 2 * kinds.count("rec")
        assert all(np.isfinite(h.loss) for h in hist)
        finals.append(list(tree_leaves(params)))
    for other in finals[1:]:
        for x, y in zip(finals[0], other):
            assert torch.equal(x, y)


SERVING_SCHEMES = ("work_exchange_unknown", "oracle", "hedged", "het_mds",
                   "mds", "gradient_coded", "uniform")


@pytest.mark.gpu
@pytest.mark.parametrize("name", SERVING_SCHEMES)
def test_serving_engine_on_the_card_is_the_cpu_row_by_row(cuda_device,
                                                          name):
    """The torch serving engine's integer ledger and completion histogram
    on the card against the same engine on the CPU, row by row: both read
    the same host-drawn arrivals and service budgets, and every float sum
    that feeds an integer is order-free (``scan._wsum``), so the rows are
    expected bitwise; at least 99% must be, as ``chip_smoke.py`` holds
    the fig-load studies.  The CPU tiers its queue and the card does
    not, so this also holds the tier's splice."""
    from repro_torch.core import HetSpec
    from repro_torch.serving import ServingConfig, scan
    het = HetSpec.uniform_random(6, 20.0, 20.0 ** 2 / 6,
                                 np.random.default_rng(3))
    cfg = ServingConfig(loads=(0.7, 0.95), slots=300, deadline_slo=2.5,
                        admission="deadline")
    sched = het.lambdas * np.random.default_rng(2).uniform(0.5, 1.2, (5, 6))
    args = (het, name, {}, cfg, 12, 8, 21, 0, sched)
    card, meta = scan.sweep_rows(*args, device=cuda_device)
    host, _ = scan.sweep_rows(*args, device="cpu")
    same = np.ones(16, dtype=bool)
    for key in scan.LEDGER_FIELDS + ("hist",):
        eq = card[key] == host[key]
        same &= eq.all(axis=1) if eq.ndim == 2 else eq
    assert same.mean() >= 0.99, f"{same.mean():.3f} of rows equal"
    for key in ("moved_w", "qd_sum"):
        assert np.array_equal(card[key][same], host[key][same])
    # the card runs one full-width pass: the queue tiers on the CPU only
    assert meta["passes"] == 1


@pytest.mark.gpu
def test_serving_geometric_sizes_and_the_layer_on_the_card(cuda_device):
    """Geometric job sizes draw on the card's generator (no tiering) and
    close the ledger; a serving spec on the torch engine runs through
    ``run_experiment`` on the card, every row stamped ``torch``."""
    from repro_torch.core import HetSpec
    from repro_torch.experiments import ExperimentSpec, ScenarioGrid, \
        run_experiment, scheme_spec
    from repro_torch.serving import ServingConfig, run_serving_grid
    het = HetSpec.uniform_random(6, 20.0, 20.0 ** 2 / 6,
                                 np.random.default_rng(3))
    cfg = ServingConfig(loads=(0.6, 0.9), slots=300,
                        job_units_dist="geometric", backend="torch")
    for rep in run_serving_grid("hedged", {}, [het], cfg, 12, 8, 5,
                                device=cuda_device):
        e = rep.extra
        assert e["serving_backend"] == "torch" and e["completed_jobs"] > 0
        assert e["units_admitted"] == pytest.approx(
            e["units_served"] + e["units_cancelled"] + e["units_backlog"])
    spec = ExperimentSpec(
        name="card-serving",
        grid=ScenarioGrid(K=8, points=[(20.0, 20.0 ** 2 / 6, 5)]),
        schemes=(scheme_spec("work_exchange"), scheme_spec("het_mds")),
        N=100, trials=4, seed=1234,
        serving=ServingConfig(loads=(0.6, 0.9), slots=300,
                              deadline_slo=4.0, backend="torch"))
    result = run_experiment(spec, device=cuda_device)
    rows = [r for key in result.keys() for r in result.report(key)]
    assert len(rows) == 4 and result.env["device"].startswith("cuda")
    assert all(r.extra["serving_backend"] == "torch" for r in rows)


@pytest.mark.gpu
def test_live_payload_and_episode_on_the_card(cuda_device):
    """The live control plane's matmul payload on the card draws the CPU's
    bits and computes its ``y`` within 1e-5; a short ``inproc`` episode
    with the payload on the card completes, conserves its ledger and
    reports the payload's device milliseconds."""
    from repro_torch.control import LiveConfig, MatmulPayload, run_live
    from repro_torch.core import HetSpec
    cpu = MatmulPayload(500, 4, 64, seed=3, device="cpu")
    card = MatmulPayload(500, 4, 64, seed=3, device=cuda_device)
    assert torch.equal(card.A.cpu(), cpu.A) and torch.equal(card.x.cpu(),
                                                            cpu.x)
    for ids in ([7], list(range(0, 500, 3)), list(range(500))):
        assert card.compute(ids) == cpu.compute(ids)
    torch.testing.assert_close(card.y.cpu(), cpu.y, rtol=1e-5, atol=1e-5)
    assert card.verify() and card.device_ms() > 0
    het = HetSpec.uniform_random(4, 4.0, 4.0 ** 2 / 6,
                                 np.random.default_rng(2))
    rep = run_live("work_exchange", {}, het, 2000,
                   LiveConfig(target_wall_s=0.2), trials=2, seed=1,
                   device=cuda_device)
    cp = rep.extra["control_plane"]
    led = cp["ledger"]
    assert led["units_dispatched"] == (led["units_completed"]
                                       + led["units_reassigned"])
    assert led["units_completed"] == 2 * 2000
    assert cp["payload_backend"] == "torch" and cp["payload_device_ms"] > 0
