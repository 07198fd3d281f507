"""Spec -> Plan compilation: resolve every execution knob up front.  The
port of ``repro.experiments.plan``.

``compile_plan`` turns a declarative ``ExperimentSpec`` into an
execution ``Plan``:

* the sampler backend is resolved (the explicit field, else
  ``$REPRO_SAMPLER_BACKEND``, else the port's default ``cuda``) and
  validated against the registry; a serving spec's queueing engine is
  resolved too (the explicit field, else ``$REPRO_SERVING_BACKEND``,
  else ``numpy``), and its concrete name lands in the stored spec;
* the device count is normalized to a concrete int, as the reference
  normalizes it: backends with a row-split executor
  (``SHARDED_BACKENDS``: ``torch``, ``cuda``) take ``"auto"`` as every
  card and an int clamped to ``torch.cuda.device_count()`` (1 on a host
  without one); every other backend, a fused panel off ``cuda``, a
  training spec and a serving spec on the numpy engine pin 1; a live
  spec is one asyncio event loop and pins 1 whatever the backend, and
  its transport is built here, so a bad one fails at compile time;
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
import torch

from ..control.coordinator import live_supported
from ..core.samplers import grid_bucket_shape, resolve_backend
from ..core.schemes import get_scheme
from ..core.types import HetSpec
from ..serving.backends import get_serving_backend

from .spec import ExperimentSpec

# backends with a multi-device executor: the row split of
# ``repro_torch.core.samplers.grid_sharding``; the rest run on one device
SHARDED_BACKENDS: Tuple[str, ...] = ("torch", "cuda")


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

    @property
    def devices(self) -> int:
        return int(self.spec.devices)

    @property
    def bucket_shape(self) -> Optional[Dict[str, int]]:
        """The padded ``(rows, K[, R])`` shape bucket this plan's grid
        calls run at on a fluid backend (None on the exact numpy engine,
        which never pads), as ``grid_bucket_shape`` gives it."""
        if self.backend not in SHARDED_BACKENDS or not self.het_specs:
            return None
        R = (None if self.rate_schedules is None
             else int(self.rate_schedules.shape[1]))
        return grid_bucket_shape(len(self.het_specs), self.spec.trials,
                                 self.het_specs[0].K, R,
                                 backend=self.backend)


def _resolve_devices(requested, backend: str) -> int:
    """``"auto"`` (or None) is every card, an int is clamped to the cards
    there are; 1 on a host without one, and for a backend without a row
    split."""
    if backend not in SHARDED_BACKENDS:
        return 1
    if requested == "auto" or requested is None:
        want = None
    else:
        want = int(requested)
        if want <= 1:
            return 1
    have = max(1, torch.cuda.device_count())
    return have if want is None else max(1, min(want, have))


def compile_plan(spec: ExperimentSpec) -> Plan:
    """Resolve backend/devices, validate tasks, materialize the grid."""
    backend = resolve_backend(spec.backend)
    devices = _resolve_devices(spec.devices, backend)
    if spec.serving is not None:
        # the queueing engine resolves like the sampler backend does
        # (explicit field > $REPRO_SERVING_BACKEND > numpy) and the
        # concrete name lands in the stored spec: the cache address
        # promises which engine produced the numbers
        sname = spec.serving.resolve_backend()
        if sname != spec.serving.backend:
            spec = spec.replace(
                serving=dataclasses.replace(spec.serving, backend=sname))
        # the torch engine stacks (load x trial) rows, a batch axis the
        # row split cuts like any other; the numpy loop is sequential in
        # time and runs on one device whatever the sampler backend
        devices = (_resolve_devices(spec.devices, "torch")
                   if get_serving_backend(sname).shards else 1)
    if spec.execution == "live":
        # live episodes are one asyncio event loop on one device, and
        # the transport must exist at compile time
        devices = 1
        spec.live.build_transport()
    if spec.panel == "fused" and backend != "cuda":
        # the torch coupled-CRN panel runs on one device; only the cuda
        # kernel path splits the stacked mixed-mode rows
        devices = 1
    if spec.training is not None:
        # the training engine is one stream of steps on one device
        devices = 1
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
