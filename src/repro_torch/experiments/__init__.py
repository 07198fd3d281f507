"""Declarative experiment API: spec -> plan -> engine -> store.  The port
of ``repro.experiments``.

The one-stop surface for the paper's (and related work's) study shape --
schemes x scenario grid x N x trials -- with a content-addressed results
store that reads the reference's entries:

    from repro_torch.experiments import (ExperimentSpec, ScenarioGrid,
                                         scheme_spec, run_experiment,
                                         default_store)

    spec = ExperimentSpec(
        name="demo",
        grid=ScenarioGrid(K=50, points=[(mu, mu * mu / 6, int(mu))
                                        for mu in (10.0, 50.0)]),
        schemes=(scheme_spec("work_exchange"), scheme_spec("hedged")),
        N=1_000_000, trials=100, seed=1234, backend="cuda")

    result = run_experiment(spec, store=default_store(), device="cuda")
    result.report("work_exchange")[0].t_comp

Module map:
    spec.py    -- ExperimentSpec / ScenarioGrid / SchemeSpec (JSON + hash)
    plan.py    -- compile_plan: resolve the backend, validate tasks
    engine.py  -- run_experiment / execute_plan (mc_grid dispatch on a
                  device)
    store.py   -- ResultsStore: results/store/<spec-hash>.json
    __main__   -- CLI: python -m repro_torch.experiments [spec.json |
                  --demo | ls | compare <hash-a> <hash-b>]

The scenario axis (``grid=``) is pluggable: any family registered in
``repro_torch.scenarios.SCENARIO_REGISTRY`` (uniform_random / explicit /
trace_corpus / drifting / hcmm_sweep).

The arrival axis is pluggable too: ``ExperimentSpec(serving=
ServingConfig(loads=(0.5, 0.8, 0.95)))`` sweeps offered load through the
streaming-arrival engine (``repro_torch.serving``), one report row per
(grid point x load) with latency percentiles in ``extra``.
"""
from ..scenarios import (SCENARIO_REGISTRY, ScenarioFamily, get_family,
                         list_families)
from ..serving import ServingConfig

from .engine import ExperimentResult, execute_plan, run_experiment
from .plan import Plan, SHARDED_BACKENDS, Task, compile_plan
from .spec import (SPEC_VERSION, ExperimentSpec, ScenarioGrid, SchemeSpec,
                   scheme_spec)
from .store import DEFAULT_STORE_ROOT, ResultsStore, default_store

__all__ = [
    "SPEC_VERSION", "ExperimentSpec", "ScenarioGrid", "SchemeSpec",
    "scheme_spec", "ServingConfig",
    "SCENARIO_REGISTRY", "ScenarioFamily", "get_family", "list_families",
    "Plan", "Task", "SHARDED_BACKENDS", "compile_plan",
    "ExperimentResult", "execute_plan", "run_experiment",
    "DEFAULT_STORE_ROOT", "ResultsStore", "default_store",
]
