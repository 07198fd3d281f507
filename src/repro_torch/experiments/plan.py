"""Spec -> Plan compilation: resolve every execution knob up front.  The
port of ``repro.experiments.plan``.

``compile_plan`` turns a declarative ``ExperimentSpec`` into an
execution ``Plan``:

* the sampler backend is resolved (the explicit field, else the port's
  default ``cuda``) and validated against the registry; a serving spec's
  queueing engine is resolved too (the explicit field, else
  ``$REPRO_SERVING_BACKEND``, else ``numpy``), and its concrete name
  lands in the stored spec;
* the device count is normalized to a concrete int: 1, since no backend
  of the port has a multi-device executor yet (``SHARDED_BACKENDS`` is
  empty), as the reference pins every backend without one; a live spec
  is one asyncio event loop and pins 1 whatever the backend, and its
  transport is built here, so a bad one fails at compile time;
* every scheme task is validated by instantiating it (unknown names and
  bad params fail at compile time, not mid-run; on a live spec, so does
  a scheme with no live path, ``live_supported``) and gets its concrete
  rng seed;
* the scenario grid is materialized into ``HetSpec`` rows.

The plan's ``spec`` field is the *resolved* spec -- the value the store
hashes, so a cache hit promises the stored numbers are what this exact
execution would produce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..control.coordinator import live_supported
from ..core.samplers import resolve_backend
from ..core.schemes import get_scheme
from ..core.types import HetSpec

from .spec import ExperimentSpec

# backends with a multi-device executor (a row split over several cards);
# none yet, so every backend runs on one device
SHARDED_BACKENDS: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Task:
    """One resolved scheme run over the whole scenario grid."""

    key: str
    scheme: str
    params: Tuple[Tuple[str, Any], ...]
    seed: int

    @property
    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)


@dataclasses.dataclass
class Plan:
    """Compiled execution plan: resolved spec + materialized work.

    ``rate_schedules`` is the scenario family's optional ``(G, R, K)``
    per-exchange-round service-rate schedule (drifting / trace-corpus
    grids), handed to every scheme task whose scheme declares
    ``supports_rate_schedule``.
    """

    spec: ExperimentSpec          # backend/devices concrete
    het_specs: List[HetSpec]
    tasks: List[Task]
    rate_schedules: Optional[np.ndarray] = None

    @property
    def spec_hash(self) -> str:
        return self.spec.spec_hash()

    @property
    def backend(self) -> str:
        return self.spec.backend


def compile_plan(spec: ExperimentSpec) -> Plan:
    """Resolve backend/devices, validate tasks, materialize the grid."""
    backend = resolve_backend(spec.backend)
    # SHARDED_BACKENDS is empty: every spec, "auto" included, runs on one
    # device, as the reference resolves a backend without a sharded
    # executor (the row split over several cards is ROADMAP.md, Queue 1
    # item 12)
    devices = 1
    if spec.serving is not None:
        # the queueing engine resolves like the sampler backend does
        # (explicit field > $REPRO_SERVING_BACKEND > numpy) and the
        # concrete name lands in the stored spec: the cache address
        # promises which engine produced the numbers.  No serving engine
        # shards yet, so devices stays 1
        sname = spec.serving.resolve_backend()
        if sname != spec.serving.backend:
            spec = spec.replace(
                serving=dataclasses.replace(spec.serving, backend=sname))
    if spec.execution == "live":
        # live episodes are one asyncio event loop on one device, and
        # the transport must exist at compile time
        devices = 1
        spec.live.build_transport()
    tasks = []
    for s in spec.schemes:
        scheme = get_scheme(s.scheme, **s.params_dict)  # fail fast
        if spec.execution == "live":
            live_supported(scheme)      # unsupported schemes fail here
        tasks.append(Task(key=s.report_key, scheme=s.scheme,
                          params=s.params,
                          seed=int(s.seed if s.seed is not None
                                   else spec.seed)))
    resolved = spec.replace(backend=backend, devices=devices)
    return Plan(spec=resolved, het_specs=spec.grid.specs(), tasks=tasks,
                rate_schedules=spec.grid.rate_schedules())


__all__ = ["SHARDED_BACKENDS", "Task", "Plan", "compile_plan"]
