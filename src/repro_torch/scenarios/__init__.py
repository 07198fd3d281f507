"""Pluggable scenario families: the scenario axis behind one registry.
The port of ``repro.scenarios``: numpy on the host, with every family's
``specs()``, ``rate_schedules()``, ``to_dict()`` and hash the reference's.

Mirrors ``SCHEME_REGISTRY`` (policies) and ``SAMPLER_BACKENDS`` (draw
pipelines): string-keyed families, each a frozen value that materializes
into ``HetSpec`` rows (and, for non-stationary families, a per-exchange-
round rate schedule).

    from repro_torch.scenarios import SCENARIO_REGISTRY, get_family

    get_family("uniform_random")(K=50, points=[(50.0, 50.0**2/6, 1)])
    get_family("drifting")(K=50, points=[(50.0, 0.0, 1)], kind="regime")
    get_family("trace_corpus")(corpus="default_64x48", K=16,
                               windows=[(0, 0), (16, 12)])
    get_family("hcmm_sweep")(K=50, mu=50.0, sigma2=50.0**2/6, seed=3)

Module map:
    base.py      -- ScenarioFamily protocol, SCENARIO_REGISTRY,
                    scenario_from_dict (incl. PR-4 legacy-shape shim)
    families.py  -- uniform_random / explicit (ported, hash-preserving)
    drifting.py  -- AR(1) / regime-switch rate evolution across rounds
    traces.py    -- measured-trace corpora (results/traces/) +
                    trace_corpus windows
    hcmm.py      -- HCMM-style load sweep with MC-optimized het_mds
                    redundancy per point
"""
from .base import (SCENARIO_REGISTRY, ScenarioFamily, get_family,
                   list_families, register_family, scenario_from_dict)
from .drifting import DriftingScenario
from .families import ExplicitScenario, ScenarioPoint, UniformRandomScenario
from .hcmm import HCMMSweepScenario
from .traces import (DEFAULT_CORPUS, TraceCorpus, TraceCorpusScenario,
                     corpus_path, load_corpus)

__all__ = [
    "SCENARIO_REGISTRY", "ScenarioFamily", "register_family", "get_family",
    "list_families", "scenario_from_dict",
    "ScenarioPoint", "UniformRandomScenario", "ExplicitScenario",
    "DriftingScenario",
    "DEFAULT_CORPUS", "TraceCorpus", "corpus_path", "load_corpus",
    "TraceCorpusScenario",
    "HCMMSweepScenario",
]
