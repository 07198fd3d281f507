#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``; no JAX, nothing of ``repro``):

1. the card's name and power limit;
2. builds the ``we_rounds`` CUDA kernel from ``src/repro_torch/csrc``;
3. holds the kernel against its plain PyTorch version on the card at the
   Figure 5 shape (16,384 rows x 56 bucketed workers) in four modes --
   known, unknown, drift (an AR(1) rate schedule, R = 48) and the mixed
   panel: >= 99% of rows with equal iterations, t_comp within rtol 1e-4
   and n_comm within rtol 1e-3 on those rows, batch means within 6 SE;
4. runs the main path at paper scale -- the Figure 5 grid (mu in {10, 20,
   50, 100} x sigma^2 in {0, mu^2/6}, K = 50, N = 1e6, 1000 trials) with
   the six schemes through ``mc_grid_panel(..., backend="cuda")`` -- with
   the launch counts zeroed just before and read just after, and checks
   the paper's Figure 5 claims;
5. times the kernel and its plain version (warm minimum of 3) at 16,384
   and 131,072 rows, and the whole panel's wall time.

It prints the kernel line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.  Any failed phase exits non-zero with no result line;
without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

K_PAPER, N_PAPER, TRIALS = 50, 1_000_000, 1000
MUS = (10.0, 20.0, 50.0, 100.0)
SIGMA_FRACS = (("0", 0.0), ("mu^2/6", 1.0 / 6.0))
SCHEMES = ("oracle", "fixed", "uniform", "mds", "work_exchange",
           "work_exchange_unknown")
# H100 SXM int32 ALU rate: 132 SMs x 64 int32 lanes x 1.98 GHz boost
# (NVIDIA Hopper architecture white paper); HBM3 at 3.35 TB/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
THREEFRY_INT_OPS = 77       # 2 key adds + 20 x (add, rotate, xor) + 5 x 3
ROW_AGREE, T_RTOL, C_RTOL, C_ATOL, MEAN_SE = 0.99, 1e-4, 1e-3, 1.0, 6.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def fig5_specs(HetSpec):
    """One HetSpec per Figure 5 grid point, seeded per mu as in
    ``benchmarks/common.py:make_het``."""
    points, specs = [], []
    for mu in MUS:
        for label, frac in SIGMA_FRACS:
            points.append((mu, label))
            specs.append(HetSpec.uniform_random(
                K_PAPER, mu, frac * mu * mu, np.random.default_rng(int(mu))))
    return points, specs


def panel_rows(specs, trials: int, samplers):
    """The fused panel's stacked rows exactly as ``work_exchange_panel_
    cuda`` launches them: known rows over unknown rows, K padded to its
    bucket, rows padded with copies of row 0 to the row bucket."""
    lam = np.stack([h.lambdas for h in specs]).astype(np.float32)
    half = np.repeat(samplers._pad_cols(lam, samplers.bucket_cols(
        lam.shape[1])), trials, axis=0)
    B = half.shape[0]
    rows, _ = samplers._pad_rows(np.concatenate([half, half]), bucket=128)
    flags = np.concatenate([np.ones(B), np.zeros(B),
                            np.ones(rows.shape[0] - 2 * B)])
    return rows, flags.astype(np.float32)


def ar1_schedule(rows: np.ndarray, R: int, seed: int) -> np.ndarray:
    """A made-up drift: each worker's rate follows an AR(1) log-walk
    (coefficient 0.8, innovation 0.1) from its nominal rate."""
    rng = np.random.default_rng(seed)
    B, K = rows.shape
    x = np.zeros((B, R, K), np.float32)
    eps = rng.standard_normal((B, R, K)).astype(np.float32)
    for r in range(1, R):
        x[:, r] = 0.8 * x[:, r - 1] + 0.1 * eps[:, r]
    return (rows[:, None, :] * np.exp(x)).astype(np.float32)


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Warm minimum over ``reps`` runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def compare(torch, got, want):
    """Row-level agreement of two (B, 3) [t_comp, iters, n_comm] tensors."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    eq = g[:, 1] == w[:, 1]
    frac = float(eq.mean())
    t_rel = float(np.max(np.abs(g[eq, 0] - w[eq, 0]) / np.abs(w[eq, 0])))
    t_abs = float(np.max(np.abs(g[eq, 0] - w[eq, 0])))
    c_err = np.abs(g[eq, 2] - w[eq, 2])
    c_rel = float(np.max(c_err / np.maximum(np.abs(w[eq, 2]), 1e-30)))
    c_ok = bool(np.all(c_err <= C_ATOL + C_RTOL * np.abs(w[eq, 2])))
    n = g.shape[0]
    se = np.hypot(g[:, 0].std(), w[:, 0].std()) / np.sqrt(n)
    gap = abs(g[:, 0].mean() - w[:, 0].mean()) / max(se, 1e-30)
    ok = frac >= ROW_AGREE and t_rel <= T_RTOL and c_ok and gap <= MEAN_SE
    return ok, dict(rows_equal_iters=frac, t_comp_max_rel=t_rel,
                    t_comp_max_abs=t_abs, n_comm_max_rel=c_rel,
                    mean_gap_se=float(gap))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a repo checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import HetSpec, get_scheme, mc_grid_panel
    from repro_torch.core import samplers
    from repro_torch.kernels.we_rounds import kernel as wk
    from repro_torch.kernels.we_rounds import ref as wref

    dev = torch.device("cuda", 0)
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build from the checkout's sources
    lib, build_s = wk.build(verbose=True)
    print(f"build: {lib.relative_to(ROOT)} in {build_s:.2f} s")

    # 3. kernel against its plain version at the Figure 5 shape
    points, specs = fig5_specs(HetSpec)
    rows_np, flags_np = panel_rows(specs, TRIALS, samplers)
    rows = torch.from_numpy(rows_np).to(dev)
    flags = torch.from_numpy(flags_np).to(dev)
    sched = torch.from_numpy(ar1_schedule(rows_np, 48, seed=7)).to(dev)
    seed = [int(s) for s in np.random.default_rng(2024).integers(
        0, 2 ** 32, size=2, dtype=np.uint32)]
    threshold = 0.01 * N_PAPER / K_PAPER
    cap_u = float(np.ceil(N_PAPER / K_PAPER))
    base = dict(n0=float(N_PAPER), threshold=threshold, max_iter=10_000)
    modes = {
        "known": (None, None, dict(cap=float("inf"), known=True)),
        "unknown": (None, None, dict(cap=cap_u, known=False)),
        "drift": (sched, None, dict(cap=cap_u, known=False)),
        "panel": (None, flags, dict(cap=cap_u, known=False)),
    }
    print(f"kernel vs plain at {tuple(rows.shape)} rows x workers, "
          f"seed {seed}")
    max_abs_err = 0.0
    failed = []
    for mode, (s, f, kw) in modes.items():
        got = wk.we_rounds_cuda(rows, seed, s, f, **base, **kw)
        torch.cuda.synchronize()
        if f is not None:
            cols = wref.we_rounds_reference_panel(rows, seed, f, s, **base,
                                                  cap=kw["cap"])
        else:
            cols = wref.we_rounds_reference(rows, seed, s, **base, **kw)
        want = torch.stack(cols, dim=1)
        torch.cuda.synchronize()
        ok, stats = compare(torch, got, want)
        max_abs_err = max(max_abs_err, stats["t_comp_max_abs"])
        print(f"  {mode:8s} {'ok' if ok else 'FAIL'} "
              + " ".join(f"{k}={v:.3e}" for k, v in stats.items()))
        if not ok:
            failed.append(f"kernel vs plain, {mode} mode")
    if failed:
        fail("; ".join(failed))

    # 4. the main path at paper scale
    schemes = {name: get_scheme(name) for name in SCHEMES}

    def run_panel():
        return mc_grid_panel(schemes, specs, N_PAPER, TRIALS,
                             np.random.default_rng(1234), backend="cuda",
                             device="cuda")

    wk.reset_launch_counts()
    t0 = time.perf_counter()
    reports = run_panel()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(wk.LAUNCH_COUNTS)
    print(f"main path: fig5 panel, K={K_PAPER} N={N_PAPER} trials={TRIALS} "
          f"grid={len(specs)}: {first_s:.3f} s (first run); launches "
          f"{launches}")
    if launches["we_rounds"] < 1:
        fail("the main path launched the we_rounds kernel no time")
    print("  mu     sigma2   oracle_exact " + " ".join(
        f"{n[:14]:>14s}" for n in SCHEMES))
    checks = []
    for g, ((mu, label), het) in enumerate(zip(points, specs)):
        exact = N_PAPER / het.lambda_sum
        row = {n: reports[n][g].t_comp for n in SCHEMES}
        print(f"  {mu:5.0f}  {label:7s}  {exact:12.2f} " + " ".join(
            f"{row[n]:14.2f}" for n in SCHEMES))
        for n in SCHEMES:
            rep = reports[n][g]
            if rep.trials != TRIALS or not np.isfinite(rep.t_comp):
                checks.append((f"{n}[mu={mu},{label}] finite, "
                               f"{TRIALS} trials", False))
        tag = f"fig5[mu={mu:g},s2={label}]"
        checks.append((f"{tag} WE-known within 5% of oracle",
                       row["work_exchange"] <= 1.05 * exact))
        checks.append((f"{tag} WE-unknown within 10% of oracle",
                       row["work_exchange_unknown"] <= 1.10 * exact))
        if label != "0":
            checks.append((f"{tag} MDS >= WE",
                           row["mds"] >= row["work_exchange"]))
        checks.append((f"{tag} fixed >= oracle",
                       row["fixed"] >= 0.999 * exact))
    bad = [name for name, ok in checks if not ok]
    print(f"paper-claim checks: {len(checks) - len(bad)}/{len(checks)} "
          f"passed")
    if bad:
        fail("claim checks failed: " + "; ".join(bad))

    # 5. times (warm minimum of 3)
    def kernel_fn(r, fl):
        return lambda: wk.we_rounds_cuda(r, seed, None, fl, **base,
                                         cap=cap_u, known=False)

    def plain_fn(r, fl):
        return lambda: wref.we_rounds_reference_panel(r, seed, fl, **base,
                                                      cap=cap_u)

    rows_big_np, flags_big_np = panel_rows(specs, 8 * TRIALS, samplers)
    sizes = {rows.shape[0]: (rows, flags),
             rows_big_np.shape[0]: (torch.from_numpy(rows_big_np).to(dev),
                                    torch.from_numpy(flags_big_np).to(dev))}
    times = {}
    for B, (r, fl) in sizes.items():
        times[B] = (cuda_ms(torch, kernel_fn(r, fl)),
                    cuda_ms(torch, plain_fn(r, fl)))
        print(f"we_rounds at {B} rows: kernel {times[B][0]:.4f} ms, plain "
              f"{times[B][1]:.4f} ms")
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_panel()
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
    print(f"fig5 panel wall (6 schemes, 8 points x {TRIALS} trials): "
          f"{wall * 1e3:.3f} ms (warm min of 3)")

    # where the panel's time goes: each scheme group alone (the pair is
    # one fused launch), then one profiled panel for the device's share
    groups = {n: (n,) for n in SCHEMES[:4]}
    groups["work_exchange pair"] = ("work_exchange", "work_exchange_unknown")
    for label, names in groups.items():
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            mc_grid_panel({n: schemes[n] for n in names}, specs, N_PAPER,
                          TRIALS, np.random.default_rng(1234),
                          backend="cuda", device="cuda")
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        print(f"  panel part {label:20s} {best * 1e3:9.3f} ms")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_panel()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in dev_events)
    if dev_us > 0:
        print(f"profiled panel: wall {prof_wall * 1e3:.3f} ms, device busy "
              f"{dev_us / 1e3:.3f} ms ({100 * dev_us / (prof_wall * 1e6):.2f}"
              f"% of wall); top device time:")
        for e in sorted(dev_events, key=lambda e: -e.self_device_time_total
                        )[:6]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<4d} {e.key[:70]}")
    else:
        print("profiled panel: the profiler recorded no device time "
              "(device busy share not measured)")

    # the bound at the main path's shape, from this run's rows: every busy
    # cell-round needs its Gamma and Binomial Threefry pairs
    out = wk.we_rounds_cuda(rows, seed, None, flags, **base, cap=cap_u,
                            known=False)
    rounds = float(out[:, 1].double().sum().item())
    ops = rounds * K_PAPER * 2 * THREEFRY_INT_OPS
    nbytes = rows.numel() * 4 + flags.numel() * 4 + out.numel() * 4
    ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, \
        nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"bound at {rows.shape[0]} rows: {ops:.4e} int ops -> "
          f"{ops_ms:.4f} ms; {nbytes} bytes -> {bytes_ms:.5f} ms")
    B0 = rows.shape[0]
    print(json.dumps({"kernels": [{
        "name": "we_rounds", "route": "cuda",
        "source": "src/repro_torch/csrc/we_rounds.cu",
        "replaces": "src/repro/kernels/we_rounds/kernel.py:65",
        "launches": launches["we_rounds"],
        "max_abs_err": max_abs_err,
        "ms": times[B0][0], "plain_ms": times[B0][1],
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
