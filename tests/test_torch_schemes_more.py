"""The port's three scenario schemes (``het_mds``, ``hedged``,
``trace_replay``) and its copies of ``core/{erlang,oracle,mds}.py`` held
against the JAX package's, on the CPU.

Every comparison hands the same heterogeneity specs and the same seeded
numpy Generators to both packages (K 12, N 20,000).  The three schemes
draw with numpy on the host in both, whatever the backend, so their
``simulate``, ``mc`` and ``mc_grid`` are held **bit for bit** (``==`` on
the reports' dicts, per-trial arrays included) with the port on its
``numpy`` and ``cuda`` backends against the reference on ``numpy`` and
``pallas``.  ``trace_replay`` runs the ported master protocol over the
ported ``VirtualWorkerPool`` from each of its three trace sources (the
synthetic drift profile, a literal matrix and the committed corpus).
The Erlang recursion, the oracle closed forms and samplers and the MDS
optimizers are numpy in both and held exactly.
"""
import warnings

import numpy as np
import pytest

import repro.core as ref_core
from repro.core import erlang as ref_erlang
from repro.core import mds as ref_mds
from repro.core import oracle as ref_oracle
from repro_torch.core import HetSpec, erlang, get_scheme, mds, oracle

K, N, TRIALS = 12, 20_000, 300
# (port backend, reference backend): the same host draws on both
BACKENDS = (("numpy", "numpy"), ("cuda", "pallas"))
TRACES = np.abs(np.random.default_rng(4).normal(3.0, 1.0, (K, 5))) + 0.1
# scheme name -> constructor params, one entry per variant held
VARIANTS = {
    "het_mds": {}, "hcmm r=1": {"redundancy": 1.0},
    "het_mds r=1.6": {"redundancy": 1.6},
    "hedged": {}, "replicate_slowest": {},
    "trace_replay": {}, "trace_replay traces": {"traces": TRACES},
    "trace_replay corpus": {"corpus": "default_64x48", "worker_offset": 5,
                            "epoch_start": 40, "epochs": 12},
}


def scheme_of(variant):
    return variant.split(" ")[0]


def ref_specs(G=3, seed=5, K=K):
    rng = np.random.default_rng(seed)
    return [ref_core.HetSpec.uniform_random(K, mu, mu * mu / 6, rng)
            for mu in (10.0, 20.0, 40.0)[:G]]


def port_specs(G=3, seed=5, K=K):
    return [HetSpec.from_dict(h.to_dict()) for h in ref_specs(G, seed, K)]


def both(variant):
    params = VARIANTS[variant]
    return (get_scheme(scheme_of(variant), **params),
            ref_core.get_scheme(scheme_of(variant), **params))


def trials_for(variant):
    # trace_replay's mc is a loop of the master protocol: fewer trials
    return 20 if variant.startswith("trace_replay") else TRIALS


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_simulate_is_the_reference(variant):
    ours, theirs = both(variant)
    for seed in range(3):
        a = ours.simulate(port_specs(1)[0], N, np.random.default_rng(seed))
        b = theirs.simulate(ref_specs(1)[0], N, np.random.default_rng(seed))
        assert (a.t_comp, a.iterations, a.n_comm) == \
            (b.t_comp, b.iterations, b.n_comm)
        assert np.array_equal(a.n_done, b.n_done)
        if not variant.startswith(("het", "hcmm")):
            # het_mds credits every coded load: it ships more than N units
            assert int(a.n_done.sum()) == N
    assert np.array_equal(ours.initial_sizes(port_specs(1)[0], N),
                          theirs.initial_sizes(ref_specs(1)[0], N))


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[0])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mc_is_the_reference(variant, backends):
    ours, theirs = both(variant)
    T = trials_for(variant)
    a = ours.mc(port_specs(1)[0], N, T, np.random.default_rng(11),
                keep_trials=True, backend=backends[0], device="cpu")
    b = theirs.mc(ref_specs(1)[0], N, T, np.random.default_rng(11),
                  keep_trials=True, backend=backends[1])
    assert a.to_dict() == b.to_dict()
    assert a.trials == T


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[0])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mc_grid_is_the_reference(variant, backends):
    ours, theirs = both(variant)
    T = trials_for(variant) // 2
    a = ours.mc_grid(port_specs(), N, T, np.random.default_rng(12),
                     keep_trials=True, backend=backends[0], device="cpu")
    b = theirs.mc_grid(ref_specs(), N, T, np.random.default_rng(12),
                       keep_trials=True, backend=backends[1])
    assert [r.to_dict() for r in a] == [r.to_dict() for r in b]
    assert len(a) == 3


def test_schemes_grid_mixed_k_and_edges_are_the_reference():
    """Mixed-K grids fall back to the per-spec loop; one worker leaves
    ``hedged`` nobody to hedge with (no spare, no straggler)."""
    mixed_ref = ref_specs(2) + ref_specs(1, seed=6, K=7)
    mixed = [HetSpec.from_dict(h.to_dict()) for h in mixed_ref]
    for name in ("het_mds", "hedged"):
        a = get_scheme(name).mc_grid(mixed, N, 40, np.random.default_rng(3),
                                     device="cpu")
        b = ref_core.get_scheme(name).mc_grid(mixed_ref, N, 40,
                                              np.random.default_rng(3))
        assert [r.to_dict() for r in a] == [r.to_dict() for r in b]
    one_ref = ref_core.HetSpec(np.array([3.0]))
    a = get_scheme("hedged").mc(HetSpec(np.array([3.0])), 50, 30,
                                np.random.default_rng(1), device="cpu")
    b = ref_core.get_scheme("hedged").mc(one_ref, 50, 30,
                                         np.random.default_rng(1))
    assert a.to_dict() == b.to_dict() and a.extra == {}
    with pytest.raises(ValueError, match="redundancy"):
        get_scheme("het_mds", redundancy=0.9)
    with pytest.raises(ValueError, match="workers"):
        get_scheme("trace_replay", traces=TRACES[:3]).simulate(
            port_specs(1)[0], N, np.random.default_rng(0))


def test_trace_replay_scheduler_is_the_reference():
    """``make_scheduler`` (the training executors' path) builds the same
    master at the nominal rates: the first assignment is equal."""
    rates = ref_specs(1)[0].lambdas
    a = get_scheme("trace_replay").make_scheduler(range(500), rates=rates)
    b = ref_core.get_scheme("trace_replay").make_scheduler(range(500),
                                                           rates=rates)
    qa, qb = a.next_assignment(), b.next_assignment()
    assert qa.queues == qb.queues and a.threshold == b.threshold


def test_erlang_oracle_and_mds_are_the_reference():
    lam = np.array([1.0, 2.5, 0.7, 4.0])
    het, ref_het = HetSpec(lam), ref_core.HetSpec(lam)
    for m in (1, 3):
        assert np.array_equal(erlang.erlang_order_stat_means(het, m),
                              ref_erlang.erlang_order_stat_means(ref_het, m))
        for j in range(1, 5):
            assert erlang.p_j_m(het, j, m) == ref_erlang.p_j_m(ref_het, j, m)
    assert erlang.erlang_order_stat_mean(het, 4, 2) == \
        ref_erlang.erlang_order_stat_mean(ref_het, 4, 2)
    assert erlang.erlang_order_stat_mean_mc(
        het, 4, 2, 500, np.random.default_rng(0)) == \
        ref_erlang.erlang_order_stat_mean_mc(ref_het, 4, 2, 500,
                                             np.random.default_rng(0))
    assert oracle.oracle_mean_time(het, 40) == \
        ref_oracle.oracle_mean_time(ref_het, 40)
    assert np.array_equal(oracle.oracle_expected_done(het, 40),
                          ref_oracle.oracle_expected_done(ref_het, 40))
    assert np.array_equal(
        oracle.oracle_time_samples(het, 40, 64, np.random.default_rng(2)),
        ref_oracle.oracle_time_samples(ref_het, 40, 64,
                                       np.random.default_rng(2)))
    assert oracle.oracle_mean_time_enumerated(het, 4) == \
        ref_oracle.oracle_mean_time_enumerated(ref_het, 4)
    assert oracle.oracle_mean_time_enumerated(het, 4) == \
        pytest.approx(oracle.oracle_mean_time(het, 4), rel=1e-12)
    for L in (1, 3):
        assert mds.mds_mean_time_exact(het, 9, L) == \
            ref_mds.mds_mean_time_exact(ref_het, 9, L)
    assert mds.mds_optimize_exact(het, 9) == \
        ref_mds.mds_optimize_exact(ref_het, 9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert mds.mds_optimize_mc(het, 9, 200, np.random.default_rng(5),
                                   device="cpu") == \
            ref_mds.mds_optimize_mc(ref_het, 9, 200,
                                    np.random.default_rng(5))
    with pytest.raises(ValueError, match="L must be"):
        erlang.erlang_order_stat_means(het, 2, L=5)
