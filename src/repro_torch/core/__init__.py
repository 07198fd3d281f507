"""Work-exchange core of the PyTorch / CUDA port.

Layout (each module the counterpart of its namesake in ``repro.core``)
  types        -- HetSpec / RunStats / ExchangeConfig dataclasses
  registry     -- the generic string-keyed plugin registry
  assignment   -- proportional / capped / uniform allocation rules, scalar
                  and trial-batched (largest-remainder, water-filling)
  estimator    -- online rate estimation (paper eq. 23 + EMA + Bayesian)
  exchange     -- unit-id-level master protocol (Algorithms 1 & 3) and the
                  one-shot cover scheduler of gradient coding
  samplers     -- the sampler backends behind Scheme.mc + mc_grid: the
                  exact numpy engine (``numpy``, host), the fused
                  we_rounds kernel (``cuda``; its plain PyTorch version on
                  the CPU) and the fluid engine as torch ops (``torch``,
                  ``fluid``); ``grid_sharding`` splits rows over devices
  schemes      -- the policy surface: oracle, fixed, uniform, mds, work
                  exchange with known / unknown rates, het_mds,
                  trace_replay, gradient_coded, hedged;
                  ``simulate`` (one exact trial), ``mc``, ``mc_grid``,
                  ``make_scheduler``
  simulator    -- DEPRECATED free-function shims over ``schemes``
  erlang       -- exact order statistics of heterogeneous Erlangs (eqs. 4-5)
  oracle       -- Theorem 1 / Corollary 2 closed forms and samplers
  mds          -- the (K, L) MDS baseline, exact and Monte Carlo (eq. 6)
  coded        -- executable MDS matmul + gradient coding baselines
  runtime      -- real-gradients / virtual-clock heterogeneous runtime
                  (``VirtualWorkerPool`` incl. measured-trace replay)

Three-line API:

    >>> from repro_torch.core import HetSpec, get_scheme
    >>> het = HetSpec.uniform_random(50, 50.0, 50.0**2 / 6, rng)
    >>> report = get_scheme("work_exchange").mc(het, N=1_000_000,
    ...                                         trials=100, rng=rng)

Every ``mc`` entry point runs on ``device="cuda"`` unless the caller
passes ``device="cpu"``.
"""
from . import (assignment, coded, erlang, estimator, exchange, mds, oracle,
               registry, runtime, samplers, schemes, simulator, types)
from .registry import Registry
from .samplers import (SAMPLER_BACKENDS, get_backend, list_backends,
                       register_backend, resolve_backend)
from .schemes import (MCReport, SCHEME_REGISTRY, Scheme, get_scheme,
                      list_schemes, mc_grid_panel, register_scheme)
from .types import ExchangeConfig, HetSpec, RunStats

__all__ = [
    "assignment", "coded", "erlang", "estimator", "exchange", "mds",
    "oracle", "registry", "runtime", "samplers", "schemes", "simulator",
    "types",
    "Registry", "MCReport", "Scheme", "SCHEME_REGISTRY", "get_scheme",
    "list_schemes", "mc_grid_panel", "register_scheme",
    "SAMPLER_BACKENDS", "get_backend", "list_backends", "register_backend",
    "resolve_backend", "ExchangeConfig", "HetSpec", "RunStats",
]
