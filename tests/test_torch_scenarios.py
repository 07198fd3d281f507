"""The port's scenario families (``repro_torch.scenarios``) held against
the JAX package's ``repro.scenarios``, on the CPU.

Each family is built in both packages from the same ``to_dict`` and
materialized: ``specs()`` (the rate vectors and each ``HetSpec``'s
canonical hash), ``rate_schedules()`` and ``to_dict()`` are held **bit
for bit** (numpy in both, the same seeded draws), and so is the
``spec_hash`` of an ``ExperimentSpec`` over the family -- the address
the results store keys by.  The measured-trace corpus loads to the same
matrix and metadata, and ``TraceCorpus.window`` wraps the same way.
"""
import numpy as np
import pytest

import repro.experiments as ref_exp
import repro.scenarios as ref_sc
import repro_torch.experiments as exp
import repro_torch.scenarios as sc

FAMILIES = {
    "uniform_random": {"K": 9, "points": [[10.0, 10.0 ** 2 / 6, 10],
                                          [20.0, 0.0, 20]]},
    "explicit": {"explicit": [{"lambdas": [1.0, 2.5, 0.5]},
                              {"lambdas": [3.0, 0.25, 4.0]}]},
    "drifting ar1": {"family": "drifting", "K": 8,
                     "points": [[20.0, 20.0 ** 2 / 6, 1], [50.0, 0.0, 2]],
                     "kind": "ar1", "rounds": 12},
    "drifting regime": {"family": "drifting", "K": 8,
                        "points": [[30.0, 150.0, 4]], "kind": "regime",
                        "rounds": 20, "regime_prob": 0.2,
                        "recover_prob": 0.3},
    "hcmm_sweep": {"family": "hcmm_sweep", "K": 6, "mu": 30.0,
                   "sigma2": 150.0, "seed": 3, "loads": [4, 32],
                   "redundancies": [1.0, 1.25, 1.5], "opt_trials": 48},
    "trace_corpus": {"family": "trace_corpus", "corpus": "default_64x48",
                     "K": 16, "windows": [[0, 0], [24, 16], [60, 45]],
                     "epochs": 12},
}


def both(name):
    d = FAMILIES[name]
    return sc.scenario_from_dict(d), ref_sc.scenario_from_dict(d)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_materializes_as_the_reference(name):
    ours, theirs = both(name)
    assert ours.family == theirs.family == name.split(" ")[0]
    assert ours.to_dict() == theirs.to_dict()
    assert list(ours.to_dict()) == list(theirs.to_dict())
    assert sc.scenario_from_dict(ours.to_dict()) == ours
    a, b = ours.specs(), theirs.specs()
    assert len(ours) == len(theirs) == len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.lambdas, y.lambdas)
        assert x.canonical_hash() == y.canonical_hash()
    ra, rb = ours.rate_schedules(), theirs.rate_schedules()
    assert (ra is None) == (rb is None)
    if ra is not None:
        assert ra.shape == rb.shape and np.array_equal(ra, rb)
    assert ours.K == theirs.K


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_spec_hash_over_the_family_is_the_reference(name):
    ours, theirs = both(name)
    kw = dict(name=f"t-{name}", N=1000, trials=4, seed=7, backend="numpy")
    a = exp.ExperimentSpec(grid=ours, schemes=(
        exp.scheme_spec("work_exchange"),
        exp.scheme_spec("het_mds", key="h", redundancy=1.5)), **kw)
    b = ref_exp.ExperimentSpec(grid=theirs, schemes=(
        ref_exp.scheme_spec("work_exchange"),
        ref_exp.scheme_spec("het_mds", key="h", redundancy=1.5)), **kw)
    assert a.canonical_json() == b.canonical_json()
    assert a.spec_hash() == b.spec_hash()
    assert exp.ExperimentSpec.from_json(a.to_json()) == a


def test_hcmm_operating_points_are_the_reference():
    ours, theirs = both("hcmm_sweep")
    for (h, n, r), (hr, nr, rr) in zip(ours.operating_points(),
                                       theirs.operating_points()):
        assert np.array_equal(h.lambdas, hr.lambdas)
        assert (n, r) == (nr, rr)
    assert ours.het_mds_params(1) == theirs.het_mds_params(1)
    assert ours.point_N(1) == theirs.point_N(1) == 32 * 6


def test_trace_corpus_and_windows_are_the_reference():
    ours, theirs = sc.load_corpus(), ref_sc.load_corpus()
    assert ours.name == theirs.name == sc.DEFAULT_CORPUS
    assert ours.meta == theirs.meta
    assert np.array_equal(ours.rates, theirs.rates)
    assert not ours.rates.flags.writeable
    for args in ((16,), (16, 56, 40, 20), (70, 3, 47, 100), (5, 0, 0, 1)):
        assert np.array_equal(ours.window(*args), theirs.window(*args))
    assert sc.corpus_path("default_64x48").name == "default_64x48.json"
    fam = sc.scenario_from_dict(FAMILIES["trace_corpus"])
    assert fam.trace_replay_params(1) == \
        ref_sc.scenario_from_dict(FAMILIES["trace_corpus"]) \
        .trace_replay_params(1)
    with pytest.raises(FileNotFoundError, match="no_such_corpus"):
        sc.load_corpus("no_such_corpus")
    with pytest.raises(ValueError, match="K > 0"):
        ours.window(0)


def test_from_dict_is_strict_as_the_reference():
    assert sc.list_families() == ref_sc.list_families()
    for bad in ({"family": "drifting", "K": 4, "points": [[1.0, 0.0, 1]],
                 "rho_typo": 0.5},
                {"family": "nope", "K": 4},
                {"K": 4},
                {"K": 4, "points": [[1.0, 0.0, 1]], "extra": 1}):
        with pytest.raises(KeyError, match="uniform_random"):
            sc.scenario_from_dict(bad)
        with pytest.raises(KeyError):
            ref_sc.scenario_from_dict(bad)
    with pytest.raises(ValueError, match="kind"):
        sc.DriftingScenario(K=4, points=[(1.0, 0.0, 1)], kind="bogus")
    with pytest.raises(ValueError, match="exactly one"):
        exp.ScenarioGrid(K=4)
