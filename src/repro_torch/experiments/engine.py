"""The single experiment entry point: spec in, reports out.  The port of
``repro.experiments.engine``.

``run_experiment`` compiles the spec (``repro_torch.experiments.plan``),
consults the content-addressed store, and -- on a miss or ``force`` --
executes every scheme task through ``Scheme.mc_grid`` on the resolved
sampler backend: on ``cuda`` the work-exchange tasks launch the
``we_rounds`` kernel on the card (its plain PyTorch version on the CPU),
on ``torch`` the fluid engine runs as torch ops on the device, on
``numpy`` everything draws on the host, bit for bit the reference.
``device=`` (default ``"cuda"``, which raises without a card) is an
execution argument, not a spec field, so it never enters the hash: the
``cuda`` kernel and its plain version are bitwise equal, and the
``numpy`` engine runs on the host whatever the device.  A plan with
``devices > 1`` (``torch`` / ``cuda``) runs under
``repro_torch.core.samplers.grid_sharding``: the grid calls split their
rows over the first ``devices`` cards (or that many CPU shards when
``device`` is the CPU), one stream per shard.  A serving spec
runs every scheme task as a dispatch policy through the queueing engine
its plan resolved (``repro_torch.serving``): ``numpy`` on the host, bit
for bit the reference's, or ``torch`` on ``device``.  A live spec runs
every scheme task through the asyncio control plane
(``repro_torch.control``), its workers' matmul payload on ``device``.

Seed discipline: each task draws from its own fresh
``default_rng(task.seed)``, so per-task numbers are independent of task
order and of which other tasks the spec carries -- which is what makes
the figure specs' numpy numbers the reference's stored ones bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import platform
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.samplers import grid_sharding
from ..core.schemes import MCReport, get_scheme, mc_grid_panel
from ..device import DEFAULT_DEVICE, resolve_device

from .plan import Plan, compile_plan
from .spec import ExperimentSpec
from .store import ResultsStore

RESULT_VERSION = 1


@dataclasses.dataclass
class ExperimentResult:
    """Everything one experiment run produced, serializable as stored."""

    spec: ExperimentSpec              # resolved: backend/devices concrete
    spec_hash: str
    reports: Dict[str, List[MCReport]]    # task key -> one row per point
    env: Dict[str, Any]
    wall_s: float
    cache_hit: bool = False           # set by run_experiment on a store hit

    def report(self, key: str) -> List[MCReport]:
        return self.reports[key]

    def keys(self) -> List[str]:
        return list(self.reports)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": RESULT_VERSION,
            "spec": self.spec.to_dict(),
            "spec_hash": self.spec_hash,
            "reports": {k: [r.to_dict() for r in rows]
                        for k, rows in self.reports.items()},
            "env": dict(self.env),
            "wall_s": round(float(self.wall_s), 4),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentResult":
        return cls(spec=ExperimentSpec.from_dict(d["spec"]),
                   spec_hash=d["spec_hash"],
                   reports={k: [MCReport.from_dict(r) for r in rows]
                            for k, rows in d["reports"].items()},
                   env=dict(d.get("env", {})),
                   wall_s=float(d.get("wall_s", 0.0)))


def _environment(device: torch.device) -> Dict[str, Any]:
    env: Dict[str, Any] = {
        "numpy": np.__version__,
        "python": platform.python_version(),
        "torch": torch.__version__,
        "device": str(device),
    }
    if device.type == "cuda":
        env["cuda_device"] = torch.cuda.get_device_name(device)
        env["cuda_devices"] = torch.cuda.device_count()
    return env


def _execute_live(plan: Plan, device) -> Dict[str, List[MCReport]]:
    """Live specs: every scheme task executes through the asyncio control
    plane (``repro_torch.control``) -- real transport round-trips, real
    matmul shards on ``device``, ``trials`` episodes per grid point,
    measured ``T_comp`` plus the telemetry timeline in each report's
    ``extra["control_plane"]``."""
    from ..control import run_live_grid
    reports: Dict[str, List[MCReport]] = {}
    for task in plan.tasks:
        reports[task.key] = run_live_grid(
            task.scheme, task.params_dict, plan.het_specs,
            plan.spec.N, plan.spec.live, plan.spec.trials, task.seed,
            rate_schedules=plan.rate_schedules, device=device)
    return reports


def _execute_training(plan: Plan, device) -> Dict[str, List[MCReport]]:
    """Training specs: every scheme task becomes an epoch-assignment
    policy over real gradients (``repro_torch.hettrain``) -- one shared
    optimizer trajectory on ``device``, each policy's scheduler moves
    virtual wall-clock, one report row per grid point with the loss curve
    in ``extra["training"]``."""
    from ..hettrain.runner import run_training_grid
    reports: Dict[str, List[MCReport]] = {}
    for task in plan.tasks:
        reports[task.key] = run_training_grid(
            task.scheme, task.params_dict, plan.het_specs,
            plan.spec.training, plan.spec.N, plan.spec.trials, task.seed,
            rate_schedules=plan.rate_schedules, device=device)
    return reports


def _execute_serving(plan: Plan, device) -> Dict[str, List[MCReport]]:
    """Serving specs: every scheme task becomes a dispatch policy run
    through the slotted queueing engine -- one report row per (grid point
    x offered load) instead of per grid point.  The engine is the plan's
    resolved serving backend (``SERVING_BACKENDS``): the numpy oracle
    loop on the host, or the torch slot-step engine on ``device``."""
    from ..serving import run_serving_grid
    reports: Dict[str, List[MCReport]] = {}
    for task in plan.tasks:
        reports[task.key] = run_serving_grid(
            task.scheme, task.params_dict, plan.het_specs,
            plan.spec.serving, plan.spec.N, plan.spec.trials, task.seed,
            rate_schedules=plan.rate_schedules, device=device)
    return reports


def _stamp_nominal(rows: List[MCReport]) -> None:
    """The grid drifts but this scheme cannot follow it: stamp the rows so
    stored results (and the CLI table) never read as if the scheme ran
    under the drift."""
    for rep in rows:
        rep.extra["nominal_rates_only"] = 1


def execute_plan(plan: Plan, device=DEFAULT_DEVICE) -> ExperimentResult:
    """Run a compiled plan on ``device`` (no store interaction)."""
    dev = resolve_device(device)
    spec = plan.spec
    t0 = time.perf_counter()
    # the plan's row split over ``devices`` of ``dev``'s type; live and
    # training plans pin one device, so only batch and serving runs split
    shard = (grid_sharding(plan.devices, device=dev) if plan.devices > 1
             else contextlib.nullcontext())
    with shard:
        if spec.execution == "live":
            reports = _execute_live(plan, dev)
        elif spec.serving is not None:
            reports = _execute_serving(plan, dev)
        elif spec.training is not None:
            reports = _execute_training(plan, dev)
        elif spec.panel == "fused":
            # fused whole-panel dispatch: the WE known/unknown pair becomes
            # ONE engine call; every other task keeps its own per-task
            # stream (the rng mapping), bit-identical to per_scheme
            schemes = {t.key: get_scheme(t.scheme, **t.params_dict)
                       for t in plan.tasks}
            rngs = {t.key: np.random.default_rng(t.seed)
                    for t in plan.tasks}
            reports = mc_grid_panel(schemes, plan.het_specs, spec.N,
                                    spec.trials, rngs, backend=plan.backend,
                                    rate_schedule=plan.rate_schedules,
                                    device=dev)
            if plan.rate_schedules is not None:
                for key, sch in schemes.items():
                    if not sch.supports_rate_schedule:
                        _stamp_nominal(reports[key])
        else:
            reports = {}
            for task in plan.tasks:
                scheme = get_scheme(task.scheme, **task.params_dict)
                kwargs = {}
                if (plan.rate_schedules is not None
                        and scheme.supports_rate_schedule):
                    # drifting / trace-corpus scenarios: the exchange-round
                    # engines follow the schedule; single-shot schemes run
                    # at the nominal (round-0 / window-mean) rates
                    kwargs["rate_schedule"] = plan.rate_schedules
                reports[task.key] = scheme.mc_grid(
                    plan.het_specs, spec.N, trials=spec.trials,
                    rng=np.random.default_rng(task.seed),
                    backend=plan.backend, device=dev, **kwargs)
                if plan.rate_schedules is not None and not kwargs:
                    _stamp_nominal(reports[task.key])
    return ExperimentResult(spec=spec, spec_hash=plan.spec_hash,
                            reports=reports, env=_environment(dev),
                            wall_s=time.perf_counter() - t0)


def run_experiment(spec: ExperimentSpec,
                   store: Optional[ResultsStore] = None,
                   force: bool = False,
                   device=DEFAULT_DEVICE) -> ExperimentResult:
    """Compile, consult the store, execute on miss, persist.

    ``force=True`` recomputes even on a hit and refreshes the stored
    entry.  ``device`` is resolved first, so the default raises without
    a card even where the store holds the result.
    """
    dev = resolve_device(device)
    plan = compile_plan(spec)
    if store is not None and not force:
        cached = store.get(plan.spec)
        if cached is not None:
            cached.cache_hit = True
            return cached
    result = execute_plan(plan, dev)
    if store is not None:
        store.put(result)
    return result


__all__ = ["RESULT_VERSION", "ExperimentResult", "execute_plan",
           "run_experiment"]
