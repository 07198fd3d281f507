"""The cross-backend conformance battery of the port, over every backend
it registers (``numpy``, ``cuda`` -- its plain PyTorch version on the
CPU -- and ``torch``), on ``device="cpu"``: the port of
``tests/test_backend_conformance.py``.

Contract, per backend:
  * conservation -- every non-redundant scheme completes exactly N units,
    and no fluid engine completes faster than the work-conservation
    bound;
  * statistical equivalence -- mean within 6 combined SE (or 2e-3
    relative) and the spread within a 0.6-1.6 ratio of the exact numpy
    engine, stationary and drifting (``ar1``, ``regime``), and the MDS
    sweep picking an L within 2 of numpy's;
  * determinism -- same seed, same report, twice;
  * ``mc`` agreeing with ``mc_grid``.

Beside these, the ``torch`` engine is held against the reference's
``jax`` backend -- the engine it ports -- at the same bands (grid,
drift, the coupled panel and the MDS sweep), and a ``torch`` call leaves
the numpy Generator in exactly the state the reference's ``jax`` call
leaves it in.

The work-exchange runs share one ``G * trials = 512`` batch so the
reference's jitted engine compiles once per path.
"""
import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.schemes import mc_grid_panel as ref_mc_grid_panel
from repro_torch.core import HetSpec, get_scheme, list_schemes, \
    mc_grid_panel
from repro_torch.core.samplers import ENV_VAR, list_backends, \
    resolve_backend
from repro_torch.scenarios import DriftingScenario

RNG = lambda s=0: np.random.default_rng(s)  # noqa: E731

K, N, TRIALS = 15, 50_000, 512
BACKENDS = sorted(list_backends())
WE_SCHEMES = ("work_exchange", "work_exchange_unknown")
PANEL = ("oracle", "fixed", "uniform", "mds", "work_exchange",
         "work_exchange_unknown")


def make_het(K=K, mu=20.0, sigma2=20.0 ** 2 / 6, seed=3):
    return HetSpec.uniform_random(K, mu, sigma2, RNG(seed))


def ref_het(het):
    return ref_core.HetSpec.from_dict(het.to_dict())


def mean_close(a, b, trials, k=6.0, floor=2e-3):
    """|mean_a - mean_b| within k combined standard errors (or a small
    relative floor for the float32 fluid engines)."""
    se = np.hypot(a.t_comp_std, b.t_comp_std) / np.sqrt(trials)
    assert abs(a.t_comp - b.t_comp) < max(k * se, floor * b.t_comp), \
        (a.t_comp, b.t_comp, se)


def spread_close(a, b):
    ratio = a.t_comp_std / max(b.t_comp_std, 1e-12)
    assert 0.6 < ratio < 1.6, (a.t_comp_std, b.t_comp_std)


def test_the_port_registers_a_counterpart_of_each_reference_backend():
    assert BACKENDS == ["cuda", "numpy", "torch"]


def test_backend_resolves_argument_then_environment_then_default(
        monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    assert resolve_backend() == "cuda"
    monkeypatch.setenv(ENV_VAR, "torch")
    assert resolve_backend() == "torch"
    assert resolve_backend("numpy") == "numpy"
    rep = get_scheme("work_exchange").mc(make_het(), 5_000, 8, RNG(0),
                                         device="cpu")
    assert rep.extra["backend"] == "torch"
    for name in ("jax", "pallas"):
        monkeypatch.setenv(ENV_VAR, name)
        with pytest.raises(KeyError, match="cuda.*numpy.*torch"):
            resolve_backend()
        with pytest.raises(KeyError, match="cuda.*numpy.*torch"):
            get_scheme("fixed").mc(make_het(), 100, 2, RNG(0), device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
class TestConservation:
    def test_every_scheme_conserves_work(self, backend, monkeypatch):
        """With the backend selected through the environment, each
        registered scheme's exact single-trial path still completes
        exactly N units (redundant schemes ship at least N)."""
        monkeypatch.setenv(ENV_VAR, backend)
        het = make_het()
        n = 2_000
        for name in list_schemes():
            scheme = get_scheme(name)
            stats = scheme.simulate(het, n, RNG(1))
            total = int(round(float(stats.n_done.sum())))
            if scheme.redundant:
                assert total >= n, f"{name} lost work: {total} < {n}"
            else:
                stats.check_work_conserved(n)

    def test_we_time_between_oracle_and_bound(self, backend):
        het = make_het(seed=11)
        oracle = N / het.lambda_sum
        for name in WE_SCHEMES:
            rep = get_scheme(name).mc(het, N, TRIALS, RNG(2),
                                      backend=backend, device="cpu")
            assert rep.extra["backend"] == backend
            assert oracle * 0.999 <= rep.t_comp < 1.10 * oracle, \
                (name, rep.t_comp, oracle)

    def test_report_shape_contract(self, backend):
        rep = get_scheme("work_exchange").mc(make_het(), N, TRIALS, RNG(3),
                                             keep_trials=True,
                                             backend=backend, device="cpu")
        assert rep.trials == TRIALS
        for arr in (rep.t_comp_trials, rep.iterations_trials,
                    rep.n_comm_trials):
            assert arr is not None and arr.shape == (TRIALS,)
            assert np.isfinite(arr).all()
        assert (rep.iterations_trials >= 1).all()
        assert (rep.n_comm_trials >= 0).all()


@pytest.mark.parametrize("backend", BACKENDS)
class TestStatisticalEquivalence:
    @pytest.mark.parametrize("name", WE_SCHEMES)
    def test_mean_and_variance_match_numpy(self, backend, name):
        het = make_het(seed=12)
        ref = get_scheme(name).mc(het, N, TRIALS, RNG(5), backend="numpy",
                                  device="cpu")
        rep = get_scheme(name).mc(het, N, TRIALS, RNG(6), backend=backend,
                                  device="cpu")
        mean_close(rep, ref, TRIALS)
        spread_close(rep, ref)

    def test_mds_sweep_matches_numpy(self, backend):
        het = make_het(seed=13)
        ref = get_scheme("mds").mc(het, N, 400, RNG(7), backend="numpy",
                                   device="cpu")
        rep = get_scheme("mds").mc(het, N, 400, RNG(8), backend=backend,
                                   device="cpu")
        assert rep.extra["backend"] == backend
        # the fluid backends run the coupled sweep; near the optimum
        # adjacent L are statistically tied
        assert abs(rep.extra["L"] - ref.extra["L"]) <= 2
        mean_close(rep, ref, 400)


@pytest.mark.parametrize("backend", BACKENDS)
class TestDeterminism:
    def test_same_seed_same_report(self, backend):
        het = make_het(seed=14)
        a, b = (get_scheme("work_exchange_unknown").mc(
            het, N, TRIALS, RNG(9), keep_trials=True, backend=backend,
            device="cpu") for _ in range(2))
        np.testing.assert_array_equal(a.t_comp_trials, b.t_comp_trials)
        np.testing.assert_array_equal(a.iterations_trials,
                                      b.iterations_trials)
        np.testing.assert_array_equal(a.n_comm_trials, b.n_comm_trials)

    def test_mds_same_seed_same_report(self, backend):
        het = make_het(seed=15)
        a, b = (get_scheme("mds").mc(het, N, 128, RNG(10), keep_trials=True,
                                     backend=backend, device="cpu")
                for _ in range(2))
        assert a.extra["L"] == b.extra["L"]
        np.testing.assert_array_equal(a.t_comp_trials, b.t_comp_trials)

    def test_panel_same_seed_same_report(self, backend):
        specs = [make_het(seed=s) for s in (16, 17)]
        a, b = (mc_grid_panel({n: get_scheme(n) for n in WE_SCHEMES}, specs,
                              N, 64, RNG(11), keep_trials=True,
                              backend=backend, device="cpu")
                for _ in range(2))
        for name in WE_SCHEMES:
            for x, y in zip(a[name], b[name]):
                np.testing.assert_array_equal(x.t_comp_trials,
                                              y.t_comp_trials)
                np.testing.assert_array_equal(x.n_comm_trials,
                                              y.n_comm_trials)


def drift_grid(G=2, rounds=20, kind="ar1"):
    fam = DriftingScenario(K=K, points=tuple((20.0 * (g + 1),
                                              (20.0 * (g + 1)) ** 2 / 6,
                                              30 + g) for g in range(G)),
                           kind=kind, rounds=rounds, drift_sigma=0.2,
                           regime_prob=0.15)
    return fam.specs(), fam.rate_schedules()


@pytest.mark.parametrize("backend", BACKENDS)
class TestDriftingConformance:
    @pytest.mark.parametrize("name", WE_SCHEMES)
    @pytest.mark.parametrize("kind", ["ar1", "regime"])
    def test_mean_and_variance_match_numpy(self, backend, name, kind):
        specs, sched = drift_grid(kind=kind)
        trials = TRIALS // len(specs)
        scheme = get_scheme(name)
        ref = scheme.mc_grid(specs, N, trials, RNG(21), backend="numpy",
                             rate_schedule=sched, device="cpu")
        rep = scheme.mc_grid(specs, N, trials, RNG(22), backend=backend,
                             rate_schedule=sched, device="cpu")
        for r, m in zip(ref, rep):
            mean_close(m, r, trials)
            spread_close(m, r)

    def test_same_seed_same_report(self, backend):
        specs, sched = drift_grid()
        trials = TRIALS // len(specs)
        runs = [get_scheme("work_exchange").mc_grid(
                    specs, N, trials, RNG(23), backend=backend,
                    rate_schedule=sched, keep_trials=True, device="cpu")
                for _ in range(2)]
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a.t_comp_trials, b.t_comp_trials)
            np.testing.assert_array_equal(a.n_comm_trials, b.n_comm_trials)

    def test_drift_slower_than_nominal_never_below_bound(self, backend):
        specs, _ = drift_grid(G=1)
        het = specs[0]
        thr = np.full((20, K), 0.5) * het.lambdas[None, :]
        thr[0] = het.lambdas
        rep = get_scheme("work_exchange").mc_grid(
            [het], N, TRIALS, RNG(24), backend=backend,
            rate_schedule=thr[None], device="cpu")[0]
        oracle = N / het.lambda_sum
        assert oracle * 0.999 < rep.t_comp < 2.2 * oracle


@pytest.mark.parametrize("backend", BACKENDS)
class TestGridAgreement:
    def test_we_grid_matches_looped_mc(self, backend):
        specs = [make_het(seed=s, mu=10.0 * (s + 1),
                          sigma2=(10.0 * (s + 1)) ** 2 / 6) for s in (0, 1)]
        trials = TRIALS // len(specs)
        scheme = get_scheme("work_exchange")
        grid = scheme.mc_grid(specs, N, trials, RNG(11), backend=backend,
                              device="cpu")
        for het, g in zip(specs, grid):
            m = scheme.mc(het, N, trials, RNG(12), backend=backend,
                          device="cpu")
            mean_close(g, m, trials)
        assert grid[1].t_comp < grid[0].t_comp

    def test_mds_grid_matches_looped_mc(self, backend):
        specs = [make_het(seed=s + 20) for s in (0, 1)]
        scheme = get_scheme("mds")
        grid = scheme.mc_grid(specs, N, 300, RNG(13), backend=backend,
                              device="cpu")
        rng = RNG(14)
        for het, g in zip(specs, grid):
            m = scheme.mc(het, N, 300, rng, backend=backend, device="cpu")
            assert abs(g.extra["L"] - m.extra["L"]) <= 2
            mean_close(g, m, 300)


# ---------------------------------------------------------------------------
# the torch engine against the reference's jax engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", WE_SCHEMES)
def test_torch_grid_matches_reference_jax(name):
    specs = [make_het(seed=s, mu=10.0 * (s + 1),
                      sigma2=(10.0 * (s + 1)) ** 2 / 6) for s in (0, 1)]
    trials = TRIALS // len(specs)
    ours = get_scheme(name).mc_grid(specs, N, trials, RNG(31),
                                    backend="torch", device="cpu")
    theirs = ref_core.get_scheme(name).mc_grid(
        [ref_het(h) for h in specs], N, trials, RNG(32), backend="jax")
    for a, b in zip(ours, theirs):
        assert a.extra == {"backend": "torch"}
        mean_close(a, b, trials)
        spread_close(a, b)
        assert abs(a.n_comm - b.n_comm) / N < 0.01


@pytest.mark.parametrize("kind", ["ar1", "regime"])
def test_torch_drift_matches_reference_jax(kind):
    specs, sched = drift_grid(kind=kind)
    trials = TRIALS // len(specs)
    ours = get_scheme("work_exchange_unknown").mc_grid(
        specs, N, trials, RNG(33), backend="torch", rate_schedule=sched,
        device="cpu")
    theirs = ref_core.get_scheme("work_exchange_unknown").mc_grid(
        [ref_het(h) for h in specs], N, trials, RNG(34), backend="jax",
        rate_schedule=sched)
    for a, b in zip(ours, theirs):
        mean_close(a, b, trials)
        spread_close(a, b)


def test_torch_panel_matches_reference_jax():
    """The six schemes of Figure 5 through one panel call in each
    package: the numpy-drawn schemes bitwise, the coupled pair and the
    coupled MDS sweep within the bands."""
    specs = [make_het(seed=s, mu=mu, sigma2=mu * mu / 6)
             for s, mu in ((40, 10.0), (41, 40.0))]
    trials = TRIALS // len(specs)
    ours = mc_grid_panel({n: get_scheme(n) for n in PANEL}, specs, N,
                         trials, RNG(35), backend="torch", device="cpu")
    theirs = ref_mc_grid_panel({n: ref_core.get_scheme(n) for n in PANEL},
                               [ref_het(h) for h in specs], N, trials,
                               RNG(36), backend="jax")
    for name in PANEL:
        for a, b in zip(ours[name], theirs[name]):
            if name in ("oracle", "fixed", "uniform"):
                assert a.extra == b.extra
                continue
            mean_close(a, b, trials)
            if name == "mds":
                assert abs(a.extra["L"] - b.extra["L"]) <= 2
            else:
                assert a.extra == {"backend": "torch", "fused_panel": 1}
                spread_close(a, b)


def test_torch_call_leaves_the_generator_as_the_reference_jax_call():
    """One ``integers(2**63 - 1)`` draw per engine call, as the
    reference's ``jax`` backend takes its key: schemes that share a
    Generator stay on the reference's draws after a ``torch`` call (the
    grid, the drift grid, the MDS sweep's gamma rows and the panel)."""
    het = make_het(seed=50)
    specs, sched = drift_grid(G=2)
    calls = [
        lambda s, h, b, r: s.get_scheme("work_exchange").mc(
            h(het), 5_000, 16, r, backend=b, **dev(s)),
        lambda s, h, b, r: s.get_scheme("we_unknown").mc_grid(
            [h(x) for x in specs], 5_000, 8, r, backend=b,
            rate_schedule=sched, **dev(s)),
        lambda s, h, b, r: s.get_scheme("mds").mc(h(het), 5_000, 32, r,
                                                  backend=b, **dev(s)),
    ]

    def dev(pkg):
        return {"device": "cpu"} if pkg is port_core else {}

    for call in calls:
        rng_ours, rng_theirs = RNG(60), RNG(60)
        call(port_core, lambda h: h, "torch", rng_ours)
        call(ref_core, ref_het, "jax", rng_theirs)
        assert rng_ours.bit_generator.state == rng_theirs.bit_generator.state
        assert rng_ours.random() == rng_theirs.random()
    rng_ours, rng_theirs = RNG(61), RNG(61)
    mc_grid_panel({n: get_scheme(n) for n in WE_SCHEMES}, [het], 5_000, 8,
                  {n: rng_ours for n in WE_SCHEMES}, backend="torch",
                  device="cpu")
    ref_mc_grid_panel({n: ref_core.get_scheme(n) for n in WE_SCHEMES},
                      [ref_het(het)], 5_000, 8,
                      {n: rng_theirs for n in WE_SCHEMES}, backend="jax")
    assert rng_ours.bit_generator.state == rng_theirs.bit_generator.state


def test_waterfill_raises_on_the_torch_backend():
    with pytest.raises(ValueError, match="waterfill"):
        get_scheme("we_unknown", capped_mode="waterfill").mc(
            make_het(), N, 4, RNG(0), backend="torch", device="cpu")
