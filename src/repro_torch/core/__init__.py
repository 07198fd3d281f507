"""Work-exchange core of the PyTorch / CUDA port.

Layout (each module the counterpart of its namesake in ``repro.core``)
  types        -- HetSpec / RunStats / ExchangeConfig dataclasses
  registry     -- the generic string-keyed plugin registry
  assignment   -- proportional / capped / uniform allocation rules (scalar)
  exchange     -- the ``Assignment`` record ``Scheme.plan`` returns
  samplers     -- the ``cuda`` sampler backend (the hand-written we_rounds
                  kernel on the card, its plain PyTorch version on CPU)
  schemes      -- the policy surface: oracle, fixed, uniform, mds, and
                  work exchange with known / unknown rates

Three-line API:

    >>> from repro_torch.core import HetSpec, get_scheme
    >>> het = HetSpec.uniform_random(50, 50.0, 50.0**2 / 6, rng)
    >>> report = get_scheme("work_exchange").mc(het, N=1_000_000,
    ...                                         trials=100, rng=rng)

Every entry point runs on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
from . import assignment, exchange, registry, samplers, schemes, types
from .registry import Registry
from .samplers import (SAMPLER_BACKENDS, get_backend, list_backends,
                       register_backend, resolve_backend)
from .schemes import (MCReport, SCHEME_REGISTRY, Scheme, get_scheme,
                      list_schemes, mc_grid_panel, register_scheme)
from .types import ExchangeConfig, HetSpec, RunStats

__all__ = [
    "assignment", "exchange", "registry", "samplers", "schemes", "types",
    "Registry", "MCReport", "Scheme", "SCHEME_REGISTRY", "get_scheme",
    "list_schemes", "mc_grid_panel", "register_scheme",
    "SAMPLER_BACKENDS", "get_backend", "list_backends", "register_backend",
    "resolve_backend", "ExchangeConfig", "HetSpec", "RunStats",
]
