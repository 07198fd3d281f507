"""The port's serving subsystem (``repro_torch.serving``) held against the
JAX package's (``repro.serving``), on the CPU.

* **The numpy engine is the reference's bit for bit.**  For every
  registered scheme, ``run_serving_grid`` on ``numpy`` gives the
  reference's reports (``to_dict()`` ``==``) under a stationary and a
  drifting rate schedule, deadline admission, ``trace`` and
  ``closed_loop`` arrivals, and geometric job sizes: the same draws in
  the same order.
* **The store as oracle.**  The two ``fig-load-*-quick`` entries rerun
  equal on every field they store (the rerun also carries the three
  keys the reference added after they were written).  The full entries
  take ~18 s each and are rerun on the card's host by ``chip_smoke.py``.
* The arrival processes, the closed forms, the largest-remainder
  rounding and ``ServingConfig``'s serialization and errors are the
  reference's; ``SERVING_BACKENDS`` holds ``numpy`` and ``torch`` (the
  reference's ``jax`` name is not registered), resolved as the
  reference resolves.
* The Erlang-C anchor holds on both engines.
* A serving spec hashes as the reference's, runs through
  ``run_experiment`` into a store, and the CLI renders it (``--demo
  serving`` on the torch engine, ``ls``'s p99 line, ``compare``'s
  percentile deltas).

The torch engine's own battery is ``tests/test_torch_serving_engine.py``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import repro.serving as ref
from repro.core.types import HetSpec as RefHetSpec
from repro.experiments import ExperimentSpec as RefSpec
from repro.experiments import ScenarioGrid as RefGrid
from repro.experiments import run_experiment as ref_run_experiment
from repro.experiments import scheme_spec as ref_scheme_spec
from repro.experiments.__main__ import demo_spec as ref_demo_spec
import repro_torch.serving as port
from repro_torch.core import HetSpec, list_schemes
from repro_torch.experiments import (ExperimentResult, ExperimentSpec,
                                     ResultsStore, ScenarioGrid,
                                     compile_plan, run_experiment,
                                     scheme_spec)
from repro_torch.experiments import __main__ as cli
from repro_torch.hettrain import TrainConfig

RNG = np.random.default_rng
ROOT = Path(__file__).resolve().parents[1]
STORE = ROOT / "results" / "store"
SCHEMES = list_schemes()


def entry(path):
    return json.loads(path.read_text())


def rates(K=6, seed=3):
    return RNG(seed).uniform(8.0, 35.0, K)


# ---------------------------------------------------------------------------
# the numpy engine, bit for bit
# ---------------------------------------------------------------------------

CASES = {
    "stationary": dict(cfg=dict(), sched=False),
    "drifting-deadline": dict(cfg=dict(deadline_slo=2.5,
                                       admission="deadline"), sched=True),
    "trace-geometric": dict(cfg=dict(arrival="trace",
                                     arrival_params={"epochs": 12},
                                     job_units_dist="geometric"),
                            sched=False),
    "closed-loop": dict(cfg=dict(arrival="closed_loop",
                                 arrival_params={"think_slots": 2}),
                        sched=False),
}


def test_the_schemes_are_the_references():
    from repro.core.schemes import list_schemes as ref_list_schemes
    from repro.core.schemes import get_scheme as ref_get_scheme
    from repro_torch.core import get_scheme
    assert SCHEMES == ref_list_schemes() and len(SCHEMES) == 10
    # the generic dispatch adapter keys its completion rule off this flag
    assert [get_scheme(n).redundant for n in SCHEMES] \
        == [ref_get_scheme(n).redundant for n in SCHEMES]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", SCHEMES)
def test_numpy_engine_is_the_reference_bit_for_bit(name, case):
    c = CASES[case]
    kw = dict(loads=(0.6, 0.95), slots=160, **c["cfg"])
    lams = [rates(seed=3), rates(seed=4)]
    sched = None
    if c["sched"]:
        sched = np.stack([lam * RNG(5 + g).uniform(0.4, 1.3, (6, 6))
                          for g, lam in enumerate(lams)])
    want = ref.run_serving_grid(name, {}, [RefHetSpec(x) for x in lams],
                                ref.ServingConfig(**kw), 20, 3, 77,
                                rate_schedules=sched)
    got = port.run_serving_grid(name, {}, [HetSpec(x) for x in lams],
                                port.ServingConfig(**kw), 20, 3, 77,
                                rate_schedules=sched, device="cpu")
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert [r.extra["grid_point"] for r in got] == [0, 0, 1, 1]


def test_simulate_serving_is_the_reference_with_the_q_hi_telemetry():
    cfg = dict(loads=(0.3,), slots=300, arrival="burst",
               arrival_params={"burst_frac": 0.05})
    want = ref.simulate_serving(RefHetSpec(rates()), "work_exchange", {},
                                ref.ServingConfig(**cfg), N=5, load=0.3,
                                trials=4, rng=RNG(12))
    got = port.simulate_serving(HetSpec(rates()), "work_exchange", {},
                                port.ServingConfig(**cfg), N=5, load=0.3,
                                trials=4, rng=RNG(12))
    assert got.to_dict() == want.to_dict()
    assert got.extra["q_hi_mean"] < got.extra["q_hi_peak"]


QUICK = [p for p in sorted(STORE.glob("*.json"))
         if entry(p)["spec"]["name"].startswith("fig-load")
         and entry(p)["spec"]["name"].endswith("-quick")]


def test_the_store_holds_four_fig_load_entries():
    names = sorted(entry(p)["spec"]["name"] for p in STORE.glob("*.json")
                   if "serving" in entry(p)["spec"])
    assert names == ["fig-load-drifting", "fig-load-drifting-quick",
                     "fig-load-stationary", "fig-load-stationary-quick"]
    assert len(QUICK) == 2


@pytest.mark.parametrize("path", QUICK,
                         ids=lambda p: entry(p)["spec"]["name"])
def test_quick_fig_load_entry_reruns_equal_on_every_stored_field(path,
                                                                 tmp_path):
    stored = entry(path)
    spec = ExperimentSpec.from_dict(stored["spec"])
    assert spec.spec_hash() == path.stem
    result = run_experiment(spec, store=ResultsStore(tmp_path),
                            device="cpu")
    got = result.to_dict()["reports"]
    newer = set()
    for key, rows in stored["reports"].items():
        assert len(got[key]) == len(rows) == 2
        for mine, theirs in zip(got[key], rows):
            extra, want_extra = mine.pop("extra"), theirs["extra"]
            assert mine == {k: v for k, v in theirs.items() if k != "extra"}
            assert {k: extra[k] for k in want_extra} == want_extra
            newer |= set(extra) - set(want_extra)
    assert newer == {"latency_censored", "q_hi_mean", "q_hi_peak"}


# ---------------------------------------------------------------------------
# arrivals, closed forms, rounding, config, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,params", [
    ("poisson", {}), ("trace", {"epochs": 12}),
    ("trace", {"epoch_start": 5, "epochs": 7}), ("burst",
                                                 {"burst_frac": 0.2}),
    ("closed_loop", {"population": 3, "think_slots": 1})])
def test_arrival_counts_are_the_references(name, params):
    a, b = port.get_arrival(name, **params), ref.get_arrival(name, **params)
    assert a.closed_loop == b.closed_loop
    assert np.array_equal(a.job_counts(5, 90, 0.7, RNG(2)),
                          b.job_counts(5, 90, 0.7, RNG(2)))
    if name == "trace":
        assert np.array_equal(a.profile(90), b.profile(90))
    if name == "closed_loop":
        assert a.population_for(0.5, 8) == b.population_for(0.5, 8)


def test_arrival_registry_and_errors():
    assert port.list_arrivals() == ref.list_arrivals()
    with pytest.raises(KeyError, match="unknown arrival process"):
        port.get_arrival("nope")
    with pytest.raises(KeyError, match="bad params"):
        port.get_arrival("poisson", rate=3)
    for bad in ({"burst_frac": 0.0}, {"burst_frac": 1.5}):
        with pytest.raises(ValueError):
            port.get_arrival("burst", **bad)


def test_closed_forms_are_the_references():
    for K in (1, 2, 4, 16):
        for a in (0.0, 0.3, 0.9 * K):
            assert port.erlang_b(K, a) == ref.erlang_b(K, a)
            assert port.erlang_c(K, a) == ref.erlang_c(K, a)
    for lam, mu, K in ((2.0, 1.0, 4), (5.0, 2.0, 3), (9.0, 2.0, 4)):
        assert port.mmk_wait(lam, mu, K) == ref.mmk_wait(lam, mu, K)
        assert port.mmk_sojourn(lam, mu, K) == ref.mmk_sojourn(lam, mu, K)
    assert port.mm1_sojourn(1.0, 2.0) == ref.mm1_sojourn(1.0, 2.0) == 1.0
    assert port.mmk_sojourn(0.5, 1.0, 1) == pytest.approx(
        port.mm1_sojourn(0.5, 1.0))
    with pytest.raises(ValueError):
        port.erlang_c(2, 2.0)
    with pytest.raises(ValueError):
        port.erlang_b(0, 1.0)


def test_lr_round_rows_is_the_references():
    w = RNG(0).uniform(0, 3, (40, 7))
    w[::5] = 0.0
    totals = RNG(1).integers(0, 200, 40)
    got = port.lr_round_rows(w, totals)
    assert np.array_equal(got, ref.lr_round_rows(w, totals))
    assert np.array_equal(got.sum(axis=1), totals)


SERVING_CFGS = [
    dict(), dict(loads=(0.5, 0.7, 0.85, 0.95), slots=2000,
                 deadline_slo=4.0),
    dict(arrival="trace", arrival_params={"epochs": 12}, slot_dt=0.01),
    dict(admission="deadline", deadline_slo=2.0, max_queue_jobs=8,
         exchange_every=3, job_units_dist="geometric", warmup_frac=0.0),
]


@pytest.mark.parametrize("kw", SERVING_CFGS)
def test_serving_config_serializes_as_the_reference(kw):
    mine, theirs = port.ServingConfig(**kw), ref.ServingConfig(**kw)
    d = mine.to_dict()
    assert d == theirs.to_dict() and "backend" not in d
    assert json.dumps(d, sort_keys=True) == json.dumps(theirs.to_dict(),
                                                       sort_keys=True)
    assert port.ServingConfig.from_dict(d) == mine
    on_torch = dataclasses.replace(mine, backend="torch")
    assert on_torch.to_dict()["backend"] == "torch"
    assert port.ServingConfig.from_dict(on_torch.to_dict()) == on_torch


@pytest.mark.parametrize("bad", [
    dict(loads=()), dict(loads=(0.5, -1.0)), dict(job_units_dist="zipf"),
    dict(admission="lifo"), dict(admission="deadline"),
    dict(deadline_slo=0.0), dict(slots=0), dict(slot_dt=-1.0),
    dict(warmup_frac=1.0), dict(max_queue_jobs=0), dict(exchange_every=0),
    dict(arrival="nope"), dict(arrival="poisson",
                               arrival_params={"x": 1})])
def test_serving_config_fails_as_the_reference(bad):
    with pytest.raises(Exception) as want:
        ref.ServingConfig(**bad)
    with pytest.raises(want.type):
        port.ServingConfig(**bad)


def test_serving_config_strict_from_dict_and_engine_names():
    with pytest.raises(KeyError, match="unknown serving key"):
        port.ServingConfig.from_dict({"loads": [0.5], "bogus": 1})
    with pytest.raises(KeyError, match=r"unknown serving backend 'jax'; "
                                       r"have \['numpy', 'torch'\]"):
        port.ServingConfig(backend="jax")
    assert port.ServingConfig(backend="torch").backend == "torch"


def test_serving_backend_registry_and_resolution(monkeypatch):
    assert port.list_serving_backends() == ["numpy", "torch"]
    for name in ("numpy", "torch"):
        backend = port.SERVING_BACKENDS.get(name)
        # the torch engine splits its rows under grid_sharding, as the
        # reference's jax scan does; the numpy loop does not
        assert backend.description and backend.shards == (name == "torch")
        assert port.serving_backend_available(name)
    monkeypatch.delenv(port.SERVING_ENV, raising=False)
    assert port.resolve_serving_backend() == "numpy"
    assert port.resolve_serving_backend("torch") == "torch"
    monkeypatch.setenv(port.SERVING_ENV, "torch")
    assert port.resolve_serving_backend() == "torch"
    assert port.resolve_serving_backend("numpy") == "torch"
    assert port.ServingConfig().resolve_backend() == "torch"
    monkeypatch.setenv(port.SERVING_ENV, "jax")
    with pytest.raises(KeyError, match="unknown serving backend"):
        port.resolve_serving_backend()


def test_the_packages_export_the_same_names():
    assert port.__all__ == ref.__all__
    assert sorted(port.POLICY_ADAPTERS) == sorted(ref.POLICY_ADAPTERS)


@pytest.mark.parametrize("params", [{}, {"L": 4}, {"opt_trials": 16}])
def test_mds_policy_resolves_the_references_L(params):
    lam = rates()
    mine = port.dispatch_policy("mds", params, HetSpec(lam), 30)
    theirs = ref.dispatch_policy("mds", params, RefHetSpec(lam), 30)
    assert mine.L == theirs.L


# ---------------------------------------------------------------------------
# the Erlang-C anchor, on both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_mmk_sojourn_matches_erlang_c(backend):
    """Homogeneous workers, 1-unit jobs, pooled work-exchange dispatch:
    each engine IS an M/M/K simulator up to O(slot_dt), so its mean
    sojourn must hit the closed form (the reference's anchor)."""
    K, mu, load = 4, 20.0, 0.65
    cfg = port.ServingConfig(loads=(load,), slots=4000, slot_dt=0.0025,
                             warmup_frac=0.25)
    expected = port.mmk_sojourn(load * K * mu, mu, K)
    if backend == "numpy":
        rep = port.simulate_serving(HetSpec(np.full(K, mu)),
                                    "work_exchange", {}, cfg, N=1,
                                    load=load, trials=16, rng=RNG(0))
        want = ref.simulate_serving(
            RefHetSpec(np.full(K, mu)), "work_exchange", {},
            ref.ServingConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)}),
            N=1, load=load, trials=16, rng=RNG(0))
        assert rep.to_dict() == want.to_dict()
    else:
        rep = port.run_serving_grid("work_exchange", {},
                                    [HetSpec(np.full(K, mu))], cfg, 1, 16,
                                    0, backend="torch", device="cpu")[0]
        assert rep.extra["serving_backend"] == "torch"
    assert rep.t_comp == pytest.approx(expected, rel=0.15)


# ---------------------------------------------------------------------------
# the experiment layer and the CLI
# ---------------------------------------------------------------------------

def serving_spec(make_spec, make_grid, make_scheme, **serving_kw):
    cfg_cls = (port.ServingConfig if make_spec is ExperimentSpec
               else ref.ServingConfig)
    return make_spec(
        name="pin-serving",
        grid=make_grid(K=6, points=[(20.0, 20.0 ** 2 / 6, 3)]),
        schemes=(make_scheme("work_exchange"), make_scheme("fixed")),
        N=100, trials=4, seed=11,
        serving=cfg_cls(loads=(0.6, 0.9), slots=400, deadline_slo=4.0,
                        **serving_kw))


def test_serving_spec_hashes_as_the_reference():
    mine = serving_spec(ExperimentSpec, ScenarioGrid, scheme_spec)
    theirs = serving_spec(RefSpec, RefGrid, ref_scheme_spec)
    pinned = ("770dfde613e0d7df6303627d1ccbe12b"
              "867d3665e5485910235bc0fcb6deb96b")
    assert mine.spec_hash() == theirs.spec_hash() == pinned
    assert mine.to_dict() == theirs.to_dict()
    assert ExperimentSpec.from_json(mine.to_json()) == mine
    on_torch = serving_spec(ExperimentSpec, ScenarioGrid, scheme_spec,
                            backend="torch")
    assert on_torch.spec_hash() != pinned
    assert ExperimentSpec.from_json(on_torch.to_json()) == on_torch


def test_serving_spec_runs_through_the_store_as_the_reference(tmp_path):
    # the sampler backend pinned: the two packages' defaults differ
    spec = serving_spec(ExperimentSpec, ScenarioGrid,
                        scheme_spec).replace(backend="numpy")
    store = ResultsStore(tmp_path)
    result = run_experiment(spec, store=store, device="cpu")
    want = ref_run_experiment(serving_spec(
        RefSpec, RefGrid, ref_scheme_spec).replace(backend="numpy"))
    assert not result.cache_hit
    assert result.spec_hash == want.spec_hash
    assert result.to_dict()["reports"] == want.to_dict()["reports"]
    assert [len(result.report(k)) for k in result.keys()] == [2, 2]
    again = run_experiment(spec, store=store, device="cpu")
    assert again.cache_hit
    assert again.to_dict()["reports"] == result.to_dict()["reports"]
    back = ExperimentResult.from_dict(result.to_dict())
    assert back.report("fixed")[1].extra["p99"] \
        == result.report("fixed")[1].extra["p99"]


def test_compile_resolves_the_serving_engine(monkeypatch):
    spec = serving_spec(ExperimentSpec, ScenarioGrid,
                        scheme_spec).replace(backend="numpy")
    monkeypatch.delenv(port.SERVING_ENV, raising=False)
    plan = compile_plan(spec)
    assert plan.spec.serving.backend == "numpy" and plan.spec.devices == 1
    assert plan.spec_hash == spec.spec_hash()
    monkeypatch.setenv(port.SERVING_ENV, "torch")
    plan = compile_plan(spec)
    assert plan.spec.serving.backend == "torch" and plan.spec.devices == 1
    assert plan.spec_hash != spec.spec_hash()
    result = run_experiment(spec.replace(trials=2), device="cpu")
    assert all(r.extra["serving_backend"] == "torch"
               for rows in result.reports.values() for r in rows)


def test_serving_axis_excludes_the_others():
    spec = serving_spec(ExperimentSpec, ScenarioGrid, scheme_spec)
    with pytest.raises(ValueError, match="fused"):
        spec.replace(panel="fused")
    with pytest.raises(ValueError, match="mutually exclusive"):
        spec.replace(training=TrainConfig(steps=2))
    with pytest.raises(TypeError, match="ServingConfig"):
        spec.replace(serving={"loads": [0.5]})


@pytest.mark.parametrize("kind", ["serving", "serving-trace"])
def test_demo_specs_are_the_references_on_the_torch_engine(kind):
    mine, theirs = cli.demo_spec(kind), ref_demo_spec(kind)
    assert mine.serving.backend == "torch"
    on_numpy = mine.replace(serving=dataclasses.replace(mine.serving,
                                                        backend="numpy"))
    assert on_numpy.spec_hash() == theirs.spec_hash()


def test_cli_serving_demo_on_the_cpu(tmp_path, capsys):
    demo_store = str(tmp_path)
    assert cli.main(["--demo", "serving", "--device", "cpu", "--trials",
                     "4", "--store", demo_store, "--check-cache"]) == 0
    out = capsys.readouterr().out
    assert "computed in" in out and "check-cache: OK" in out
    assert "sojourn=" in out and "p99=" in out and "slo_miss=" in out
    assert cli.main(["ls", "--store", demo_store]) == 0
    out = capsys.readouterr().out
    assert "serving p99@load=0.9:" in out and "work_exchange=" in out
    h = ResultsStore(demo_store).entries()[0]
    assert cli.main(["compare", h[:16], h[:16], "--store",
                     demo_store]) == 0
    out = capsys.readouterr().out
    assert "p99" in out and "slo_miss_rate" in out
    assert "within the 6-SE MC band" in out


def test_cli_serving_trace_demo_and_the_stored_entries(capsys, tmp_path):
    assert cli.main(["--demo", "serving-trace", "--device", "cpu",
                     "--trials", "2", "--store", str(tmp_path)]) == 0
    assert "computed in" in capsys.readouterr().out
    assert cli.main(["ls", "--store", str(STORE)]) == 0
    out = capsys.readouterr().out
    # every stored entry reads back, the live one too (since the live
    # control plane was ported)
    assert "not ported yet" not in out and "unreadable" not in out
    assert out.count("serving p99@load=") == 4
    assert cli.main(["compare", "df7f3b5f", "091b7bbd", "--store",
                     str(STORE)]) == 0
    assert "p50" in capsys.readouterr().out
