"""The port's exact numpy backend and scalar paths held against the JAX
package's, on the CPU.

Every comparison hands the same heterogeneity specs and the same seeded
numpy Generators to both packages (K 15, N 50,000, as
``tests/test_backend_conformance.py``).  Both run pure numpy in the same
draw order, so the numpy grid (carry, waterfill, drift),
``gamma_rows_numpy``, the batch assignment rules, each ported scheme's
``simulate``, ``mc`` and ``mc_grid`` on the numpy backend, ``mc`` with
``engine="loop"``, the exact MDS sweep and the deprecated ``simulator``
shim are held **bit for bit** (``np.array_equal``, ``==`` on floats),
warnings included.

The ``cuda`` backend's plain CPU path (a fluid relaxation in float32) is
held against the exact engine by the reference's conformance rule,
``mean_close``: means within 6 combined standard errors or 2e-3
relative.
"""
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import assignment as ref_assign
from repro.core import samplers as ref_samplers
from repro.core import schemes as ref_schemes
from repro.core import simulator as ref_sim
from repro_torch.core import ExchangeConfig, HetSpec, get_scheme
from repro_torch.core import assignment, samplers, schemes, simulator

K, N = 15, 50_000
PORTED = ("oracle", "fixed", "uniform", "mds", "work_exchange",
          "work_exchange_unknown", "gradient_coded")
WE = ("work_exchange", "work_exchange_unknown")


def RNG(seed=0):
    return np.random.default_rng(seed)


def ref_specs(G=3, seed=5, K=K):
    rng = RNG(seed)
    return [ref_core.HetSpec.uniform_random(K, mu, mu * mu / 6, rng)
            for mu in (10.0, 20.0, 40.0)[:G]]


def port_specs(G=3, seed=5, K=K):
    return [HetSpec.from_dict(h.to_dict()) for h in ref_specs(G, seed, K)]


def drift(G=3, R=12, seed=9):
    lam = np.stack([h.lambdas for h in ref_specs(G)])
    walk = RNG(seed).normal(0.0, 0.2, size=(G, R, K)).cumsum(axis=1)
    return lam[:, None, :] * np.exp(walk)


def same_report(a, b):
    """Two MCReports bit for bit, per-trial arrays included."""
    assert a.to_dict() == b.to_dict()
    for field in ("t_comp_trials", "iterations_trials", "n_comm_trials"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x, y), field


def same_stats(a, b):
    assert (a.t_comp, a.iterations, a.n_comm) == \
        (b.t_comp, b.iterations, b.n_comm)
    assert np.array_equal(a.n_done, b.n_done)
    if a.t_iter is not None or b.t_iter is not None:
        assert np.array_equal(a.t_iter, b.t_iter)


# ---------------------------------------------------------------------------
# the batch assignment rules
# ---------------------------------------------------------------------------

def test_batch_assignment_rules_match_the_reference():
    rng = RNG(1)
    shares = rng.gamma(2.0, size=(40, K))
    shares[3] = 0.0                       # a degenerate row: ones fallback
    shares[7, :5] = 0.0
    totals = rng.integers(0, 5000, size=40)
    totals[11] = 0
    got = assignment.largest_remainder_round_batch(shares, totals)
    want = ref_assign.largest_remainder_round_batch(shares, totals)
    assert np.array_equal(got, want) and got.dtype == want.dtype
    for i in range(40):
        assert np.array_equal(got[i], assignment.largest_remainder_round(
            shares[i], int(totals[i])))
    for cap in (60, 400, 10 ** 6):
        got = assignment.capped_proportional_assignment_batch(shares,
                                                              totals, cap)
        want = ref_assign.capped_proportional_assignment_batch(shares,
                                                               totals, cap)
        assert np.array_equal(got, want)
        assert np.array_equal(
            got[5], assignment.capped_proportional_assignment(
                shares[5], int(totals[5]), cap))
    lam = shares[0] + 0.5
    assert np.array_equal(assignment.water_filling_view(lam, 1234),
                          ref_assign.water_filling_view(lam, 1234))


# ---------------------------------------------------------------------------
# the numpy backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("known", [True, False], ids=["known", "unknown"])
@pytest.mark.parametrize("capped_mode", ["carry", "waterfill"])
@pytest.mark.parametrize("drifting", [False, True], ids=["", "drift"])
def test_numpy_grid_is_the_reference_bit_for_bit(known, capped_mode,
                                                 drifting):
    lam = np.stack([h.lambdas for h in ref_specs()])
    cfg = ExchangeConfig(known_heterogeneity=known, storage_cap_frac=0.9)
    ref_cfg = ref_core.ExchangeConfig(known_heterogeneity=known,
                                      storage_cap_frac=0.9)
    sched = drift() if drifting else None
    got = samplers.work_exchange_grid_numpy(
        lam, N, cfg, 40, RNG(3), capped_mode, rate_schedule=sched,
        device="cpu")
    want = ref_samplers.work_exchange_grid_numpy(
        lam, N, ref_cfg, 40, RNG(3), capped_mode, rate_schedule=sched)
    for a, b in zip(got, want):
        assert a.shape == (3 * 40,) and np.array_equal(a, b)


def test_gamma_rows_numpy_is_the_reference_bit_for_bit():
    shape_col = np.repeat(np.arange(1.0, 9.0), 4)[:, None] * 100.0
    scale = 1.0 / ref_specs(1)[0].lambdas
    got = samplers.gamma_rows_numpy(shape_col, scale, RNG(4), device="cpu")
    want = ref_samplers.gamma_rows_numpy(shape_col, scale, RNG(4))
    assert got.shape == (32, K) and np.array_equal(got, want)
    with pytest.raises(ValueError, match="broadcast"):
        samplers.gamma_rows_numpy(np.ones(3), np.ones(3), RNG(4))


def test_numpy_backend_is_registered_as_the_reference_registers_it():
    b = samplers.get_backend("numpy")
    assert b.work_exchange_panel is None and not b.coupled_mds_sweep
    assert samplers.DEFAULT_BACKEND == "cuda"
    assert sorted(samplers.list_backends()) == ["cuda", "numpy", "torch"]
    with pytest.raises(ValueError, match="waterfill"):
        get_scheme("we_unknown", capped_mode="waterfill").mc(
            port_specs(1)[0], N, 4, RNG(0), backend="cuda", device="cpu")


# ---------------------------------------------------------------------------
# the scalar paths
# ---------------------------------------------------------------------------

SIMULATE_CASES = {
    **{name: (name, {}) for name in PORTED},
    "mds L=5": ("mds", {"L": 5}),
    "gradient_coded s=2": ("gradient_coded", {"s": 2}),
    "work_exchange_unknown waterfill": ("work_exchange_unknown",
                                        {"capped_mode": "waterfill",
                                         "storage_cap_frac": 0.8}),
}


@pytest.mark.parametrize("case", sorted(SIMULATE_CASES))
def test_simulate_is_the_reference_bit_for_bit(case):
    name, params = SIMULATE_CASES[case]
    het, ref_het = port_specs(1)[0], ref_specs(1)[0]
    for seed in (1, 2):
        same_stats(get_scheme(name, **params).simulate(het, N, RNG(seed)),
                   ref_core.get_scheme(name, **params).simulate(
                       ref_het, N, RNG(seed)))


@pytest.mark.parametrize("name", WE)
def test_simulate_with_a_rate_schedule_is_the_reference(name):
    sched = drift(G=1)[0]
    same_stats(get_scheme(name).simulate(port_specs(1)[0], N, RNG(6),
                                         rate_schedule=sched),
               ref_core.get_scheme(name).simulate(ref_specs(1)[0], N,
                                                  RNG(6),
                                                  rate_schedule=sched))
    with pytest.raises(ValueError, match="rate_schedule"):
        schemes.simulate_work_exchange_scalar(
            port_specs(1)[0], N, ExchangeConfig(), RNG(0),
            rate_schedule=np.ones((3, K + 1)))


@pytest.mark.parametrize("name", WE)
@pytest.mark.parametrize("drifting", [False, True], ids=["", "drift"])
def test_loop_engine_mc_is_the_reference(name, drifting):
    sched = drift(G=1)[0] if drifting else None
    kw = {} if sched is None else {"rate_schedule": sched}
    got = get_scheme(name, engine="loop").mc(
        port_specs(1)[0], N, 12, RNG(7), keep_trials=True, device="cpu",
        **kw)
    want = ref_core.get_scheme(name, engine="loop").mc(
        ref_specs(1)[0], N, 12, RNG(7), keep_trials=True, **kw)
    same_report(got, want)
    # at one trial the batched numpy engine draws in the scalar order
    one = get_scheme(name).mc(port_specs(1)[0], N, 1, RNG(8),
                              backend="numpy", device="cpu", **kw)
    loop = get_scheme(name, engine="loop").mc(port_specs(1)[0], N, 1,
                                              RNG(8), device="cpu", **kw)
    assert one.t_comp == loop.t_comp and one.n_comm == loop.n_comm


@pytest.mark.parametrize("name", PORTED)
def test_numpy_backend_mc_and_mc_grid_are_the_reference(name):
    scheme, ref = get_scheme(name), ref_core.get_scheme(name)
    same_report(scheme.mc(port_specs(1)[0], N, 12, RNG(9), keep_trials=True,
                          backend="numpy", device="cpu"),
                ref.mc(ref_specs(1)[0], N, 12, RNG(9), keep_trials=True,
                       backend="numpy"))
    got = scheme.mc_grid(port_specs(), N, 8, RNG(10), keep_trials=True,
                         backend="numpy", device="cpu")
    want = ref.mc_grid(ref_specs(), N, 8, RNG(10), keep_trials=True,
                       backend="numpy")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        same_report(a, b)


def test_waterfill_and_drift_grids_through_the_schemes():
    sched = drift()
    scheme = get_scheme("we_unknown", capped_mode="waterfill",
                        storage_cap_frac=0.8)
    ref = ref_core.get_scheme("we_unknown", capped_mode="waterfill",
                              storage_cap_frac=0.8)
    for a, b in zip(scheme.mc_grid(port_specs(), N, 10, RNG(11),
                                   keep_trials=True, backend="numpy",
                                   rate_schedule=sched, device="cpu"),
                    ref.mc_grid(ref_specs(), N, 10, RNG(11),
                                keep_trials=True, backend="numpy",
                                rate_schedule=sched)):
        same_report(a, b)


# ---------------------------------------------------------------------------
# the exact MDS sweep
# ---------------------------------------------------------------------------

def test_exact_mds_sweep_picks_the_reference_L_and_samples():
    het, ref_het = port_specs(1)[0], ref_specs(1)[0]
    for got, want in (
            (schemes.mds_sweep(het, N, 20, RNG(12)),
             ref_schemes.mds_sweep(ref_het, N, 20, RNG(12))),
            (schemes.mds_sweep_batched(het, N, 20, RNG(12),
                                       backend="numpy", device="cpu"),
             ref_schemes.mds_sweep_batched(ref_het, N, 20, RNG(12),
                                           backend="numpy"))):
        assert got[:2] == want[:2]
        assert np.array_equal(got[2], want[2])
    # the batched sweep on numpy is the per-L loop, bit for bit
    loop = schemes.mds_sweep(het, N, 20, RNG(13))
    batched = schemes.mds_sweep_batched(het, N, 20, RNG(13),
                                        backend="numpy", device="cpu")
    assert loop[:2] == batched[:2] and np.array_equal(loop[2], batched[2])
    # the independent cube of the grid: mc's sweep samples are the winner's
    # when trials <= opt_trials, else a top-up draw (both bitwise)
    for trials in (48, 100):
        same_report(get_scheme("mds").mc(het, N, trials, RNG(14),
                                         keep_trials=True, backend="numpy",
                                         device="cpu"),
                    ref_core.get_scheme("mds").mc(ref_het, N, trials,
                                                  RNG(14), keep_trials=True,
                                                  backend="numpy"))


# ---------------------------------------------------------------------------
# the deprecated shim
# ---------------------------------------------------------------------------

SHIM = {       # (call, whether it is a Monte-Carlo mean taking device=)
    "simulate_work_exchange": (lambda m, h, c, kw: m.simulate_work_exchange(
        h, N, c(known_heterogeneity=False), RNG(15), "waterfill"), False),
    "simulate_oracle": (lambda m, h, c, kw: m.simulate_oracle(h, N, RNG(15)),
                        False),
    "mds_mean_time": (lambda m, h, c, kw: m.mds_mean_time(
        h, N, 4, 30, RNG(15), **kw), True),
    "mds_optimize": (lambda m, h, c, kw: m.mds_optimize(
        h, N, 10, RNG(15), **kw), True),
    "fixed_mean_time": (lambda m, h, c, kw: m.fixed_mean_time(
        h, N, 30, RNG(15), **kw), True),
    "oracle_mean_time_mc": (lambda m, h, c, kw: m.oracle_mean_time_mc(
        h, N, 30, RNG(15), **kw), True),
    "work_exchange_mc": (lambda m, h, c, kw: m.work_exchange_mc(
        h, N, c(), 30, RNG(15), **kw), True),
    "work_exchange_mc loop": (lambda m, h, c, kw: m.work_exchange_mc(
        h, N, c(known_heterogeneity=False), 5, RNG(15), engine="loop",
        **kw), True),
}


@pytest.mark.parametrize("case", sorted(SHIM))
def test_simulator_shim_is_the_reference_with_its_warnings(case):
    """The port's shim draws with the exact numpy engine on the host, as
    the reference's does; its Monte-Carlo means resolve ``device=``, here
    the CPU."""
    call, takes_device = SHIM[case]
    name = case.split()[0]
    outs = []
    for mod, het, cfg, pkg, kw in (
            (simulator, port_specs(1)[0], ExchangeConfig, "repro_torch",
             {"device": "cpu"} if takes_device else {}),
            (ref_sim, ref_specs(1)[0], ref_core.ExchangeConfig, "repro",
             {})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs.append(call(mod, het, cfg, kw))
        dep = [w for w in caught if w.category is DeprecationWarning]
        assert len(dep) == 1
        assert str(dep[0].message) == (
            f"{pkg}.core.simulator.{name} is deprecated; use "
            f"{pkg}.core.schemes.get_scheme(...) instead")
    got, want = outs
    if hasattr(want, "n_done"):
        same_stats(got, want)
    elif hasattr(want, "to_dict"):
        same_report(got, want)
        assert (got.t_std, got.i_std, got.c_std) == \
            (want.t_std, want.i_std, want.c_std)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# the cuda backend's plain CPU path against the exact engine
# ---------------------------------------------------------------------------

def mean_close(a, b, trials, k=6.0, floor=2e-3):
    """|mean_a - mean_b| within k combined standard errors (+ a small
    relative floor for float32 fluid pipelines), as the reference's
    ``tests/test_backend_conformance.py`` holds its backends."""
    se = np.hypot(a.t_comp_std, b.t_comp_std) / np.sqrt(trials)
    assert abs(a.t_comp - b.t_comp) < max(k * se, floor * b.t_comp), \
        (a.t_comp, b.t_comp, se)


@pytest.mark.parametrize("name", ("mds",) + WE)
def test_cuda_plain_path_agrees_with_the_exact_engine(name):
    specs = port_specs()
    exact = get_scheme(name).mc_grid(specs, N, 160, RNG(16),
                                     backend="numpy", device="cpu")
    fluid = get_scheme(name).mc_grid(specs, N, 160, RNG(17),
                                     backend="cuda", device="cpu")
    for a, b in zip(fluid, exact):
        assert a.extra["backend"] == "cuda" and b.extra["backend"] == "numpy"
        mean_close(a, b, 160)


def test_numpy_backend_still_resolves_its_device():
    """``backend="numpy"`` chooses the host engine, not the CPU device:
    the default device still raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_scheme("work_exchange").mc(port_specs(1)[0], N, 4, RNG(0),
                                       backend="numpy")
