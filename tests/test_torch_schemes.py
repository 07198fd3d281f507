"""The port's scheme surface held against the JAX package's.

Each test makes its heterogeneity specs and Generators with numpy from
fixed seeds and hands the same seeds to both packages: the port's
``cuda`` backend on ``device="cpu"`` (its plain PyTorch version) and the
reference's ``pallas`` backend (on the CPU, the jitted jnp reference).
Both draw the Threefry key with one ``rng.integers(0, 2**32, size=2)``,
pad to the same K and row buckets, and so key the same counters.

Tolerances: work-exchange rows as in ``test_torch_cuda.py`` (>= 99%
of rows with equal iterations, ``t_comp`` rtol 1e-4 and ``n_comm`` rtol
1e-3 plus one unit on them, means at 6 combined SE); ``oracle``,
``fixed`` and ``uniform`` are the same numpy draws, so their reports are
bitwise equal; MDS picks the same L and its mean ``t_comp`` agrees to
rtol 1e-4 (float32 Gamma rows that differ by ulps).  Against the exact
numpy engine (``work_exchange_grid_numpy``) the fluid relaxation agrees
at 6 combined SE.
"""
import numpy as np
import pytest

import repro.core as ref_core
from repro.core.samplers import work_exchange_grid_numpy
from repro.core.schemes import mc_grid_panel as ref_mc_grid_panel
from repro_torch.core import ExchangeConfig, HetSpec, get_scheme, mc_grid_panel
from repro_torch.core.samplers import resolve_backend

from test_torch_cuda import assert_rows_agree

K, N = 12, 30_000
PANEL = ("oracle", "fixed", "uniform", "mds", "work_exchange",
         "work_exchange_unknown")
WE = ("work_exchange", "work_exchange_unknown")


def ref_specs(G=3, seed=5):
    rng = np.random.default_rng(seed)
    return [ref_core.HetSpec.uniform_random(K, mu, mu * mu / 6, rng)
            for mu in (10.0, 20.0, 40.0)[:G]]


def port_specs(G=3, seed=5):
    return [HetSpec.from_dict(h.to_dict()) for h in ref_specs(G, seed)]


def rows_of(report):
    return (report.t_comp_trials, report.iterations_trials,
            report.n_comm_trials)


@pytest.mark.parametrize("name", WE)
def test_we_mc_matches_pallas(name):
    ours = get_scheme(name).mc(port_specs(1)[0], N, 200,
                               np.random.default_rng(1), keep_trials=True,
                               backend="cuda", device="cpu")
    theirs = ref_core.get_scheme(name).mc(ref_specs(1)[0], N, 200,
                                          np.random.default_rng(1),
                                          keep_trials=True, backend="pallas")
    assert ours.extra == {"backend": "cuda"}
    assert ours.trials == theirs.trials == 200
    assert_rows_agree(rows_of(ours), rows_of(theirs))


@pytest.mark.parametrize("name", WE)
def test_we_mc_grid_matches_pallas(name):
    ours = get_scheme(name).mc_grid(port_specs(), N, 80,
                                    np.random.default_rng(2),
                                    keep_trials=True, device="cpu")
    theirs = ref_core.get_scheme(name).mc_grid(ref_specs(), N, 80,
                                               np.random.default_rng(2),
                                               keep_trials=True,
                                               backend="pallas")
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.extra["backend"] == "cuda"
        assert_rows_agree(rows_of(a), rows_of(b))


def test_we_drift_mc_grid_matches_pallas():
    sched = np.stack([h.lambdas for h in ref_specs()])[:, None, :] * np.exp(
        0.15 * np.random.default_rng(9).standard_normal((3, 20, K)))
    ours = get_scheme("we_unknown").mc_grid(
        port_specs(), N, 80, np.random.default_rng(3), keep_trials=True,
        rate_schedule=sched, device="cpu")
    theirs = ref_core.get_scheme("we_unknown").mc_grid(
        ref_specs(), N, 80, np.random.default_rng(3), keep_trials=True,
        backend="pallas", rate_schedule=sched)
    for a, b in zip(ours, theirs):
        assert_rows_agree(rows_of(a), rows_of(b))


def test_mc_grid_panel_matches_pallas():
    """The six schemes of Figure 5 through one panel call in each
    package, from the same Generator."""
    ours = mc_grid_panel({n: get_scheme(n) for n in PANEL}, port_specs(),
                         N, 40, np.random.default_rng(7), keep_trials=True,
                         backend="cuda", device="cpu")
    theirs = ref_mc_grid_panel({n: ref_core.get_scheme(n) for n in PANEL},
                               ref_specs(), N, 40, np.random.default_rng(7),
                               keep_trials=True, backend="pallas")
    assert list(ours) == list(PANEL)
    for name in PANEL:
        for a, b in zip(ours[name], theirs[name]):
            if name in ("oracle", "fixed", "uniform"):
                assert a.to_dict() == b.to_dict()
            elif name == "mds":
                assert a.extra == {"L": b.extra["L"], "backend": "cuda"}
                assert a.t_comp == pytest.approx(b.t_comp, rel=1e-4)
            else:
                assert a.extra == {"backend": "cuda", "fused_panel": 1}
                assert_rows_agree(rows_of(a), rows_of(b))


@pytest.mark.parametrize("L", [None, 5])
def test_mds_mc_matches_pallas(L):
    ours = get_scheme("mds", L=L).mc(port_specs(1)[0], N, 100,
                                     np.random.default_rng(4), device="cpu")
    theirs = ref_core.get_scheme("mds", L=L).mc(ref_specs(1)[0], N, 100,
                                                np.random.default_rng(4),
                                                backend="pallas")
    assert ours.extra["L"] == theirs.extra["L"]
    assert ours.t_comp == pytest.approx(theirs.t_comp, rel=1e-4)
    assert ours.n_comm == theirs.n_comm


@pytest.mark.parametrize("known", [True, False])
def test_we_within_6se_of_numpy_oracle(known):
    """The fluid relaxation against the exact integer-unit engine."""
    name = WE[0] if known else WE[1]
    het = ref_specs(1)[0]
    ours = get_scheme(name).mc(port_specs(1)[0], N, 200,
                               np.random.default_rng(11), keep_trials=True,
                               device="cpu")
    t_np, _, c_np = work_exchange_grid_numpy(
        het.lambdas[None, :], N, ExchangeConfig(known_heterogeneity=known),
        200, np.random.default_rng(12))
    t = ours.t_comp_trials
    se = np.hypot(t.std(), t_np.std()) / np.sqrt(t.size)
    assert abs(t.mean() - t_np.mean()) < 6.0 * se
    assert abs(ours.n_comm - c_np.mean()) / N < 0.01


def test_hetspec_state_carries_across():
    """A spec serialized by the reference loads in the port with the same
    content hash, and back."""
    for h in ref_specs():
        ported = HetSpec.from_dict(h.to_dict())
        assert ported.canonical_hash() == h.canonical_hash()
        assert ref_core.HetSpec.from_dict(ported.to_dict()) == h


def test_mcreport_to_dict_keys_match_reference():
    het = port_specs(1)[0]
    for keep in (False, True):
        ours = get_scheme("oracle").mc(het, N, 10, np.random.default_rng(0),
                                       keep_trials=keep, device="cpu")
        theirs = ref_core.get_scheme("oracle").mc(
            ref_specs(1)[0], N, 10, np.random.default_rng(0),
            keep_trials=keep)
        assert list(ours.to_dict()) == list(theirs.to_dict())
        assert ref_core.MCReport.from_dict(ours.to_dict()).to_dict() \
            == ours.to_dict()


@pytest.mark.parametrize("name", PANEL)
def test_plan_matches_reference(name):
    ours = get_scheme(name).plan(port_specs(1)[0], 1000)
    theirs = ref_core.get_scheme(name).plan(ref_specs(1)[0], 1000)
    assert ours.queues == theirs.queues
    assert ours.wait_all == theirs.wait_all


def test_later_slices_raise_not_implemented():
    """What the port has not taken raises: the reference's ``jax``
    backend is not registered (the port's ``torch`` backend takes its
    role), so naming it raises the registry's ``KeyError`` listing what
    is, and ``torch`` resolves.  The three scenario schemes,
    ``HetTrainer``'s trace corpora, the serving axis and, since the live
    control plane was ported, the live axis no longer raise: a live spec
    builds (``execution="live"`` fills in the default ``LiveConfig``) and
    reads back from its dict, and a dict in place of a ``ServingConfig``
    or a ``LiveConfig`` is a ``TypeError``, as in the reference."""
    from repro_torch.control import LiveConfig
    from repro_torch.experiments import ExperimentSpec, ScenarioGrid, \
        scheme_spec
    for name in ("het_mds", "hcmm", "trace_replay", "hedged",
                 "replicate_slowest", "hedged_requests"):
        assert get_scheme(name).name in ("het_mds", "trace_replay",
                                         "hedged")
    base = dict(name="x", grid=ScenarioGrid(K=4, points=[(4.0, 1.0, 1)]),
                schemes=(scheme_spec("fixed"),), N=100, trials=2)
    for live in (None, LiveConfig(transport="tcp", kill_worker=1)):
        spec = ExperimentSpec(**base, execution="live", live=live)
        assert spec.live == (live or LiveConfig())
        back = ExperimentSpec.from_dict({**ExperimentSpec(**base).to_dict(),
                                         "execution": "live",
                                         "live": spec.live.to_dict()})
        assert back == spec and back.spec_hash() == spec.spec_hash()
    with pytest.raises(TypeError, match="LiveConfig"):
        ExperimentSpec(**base, execution="live",
                       live={"transport": "inproc"})
    with pytest.raises(TypeError, match="ServingConfig"):
        ExperimentSpec(**base, serving={"loads": [0.5]})
    served = ExperimentSpec.from_dict({**ExperimentSpec(**base).to_dict(),
                                       "serving": {"loads": [0.5]}})
    assert served.serving.loads == (0.5,)
    with pytest.raises(KeyError, match="cuda.*numpy|numpy.*cuda"):
        resolve_backend("jax")
    assert resolve_backend("torch") == "torch"


def test_unknown_backend_and_scheme_fail_fast():
    with pytest.raises(KeyError, match="cuda"):
        resolve_backend("pallas")
    with pytest.raises(KeyError, match="work_exchange"):
        get_scheme("bogus")
    with pytest.raises(KeyError, match="sampler backend"):
        get_scheme("oracle").mc(port_specs(1)[0], N, 4,
                                np.random.default_rng(0), backend="nope",
                                device="cpu")
