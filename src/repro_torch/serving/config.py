"""``ServingConfig``: the streaming-arrival axis of an ExperimentSpec.  The
port of ``repro.serving.config``; it serializes byte for byte as the
reference's, so the reference's stored serving specs keep their addresses.

A frozen, JSON-lossless value (the ``SchemeSpec`` discipline: params as
sorted key/value tuples, strict ``from_dict``) that turns a batch
experiment into a load sweep: attach one to ``ExperimentSpec(serving=)``
and every scheme task runs through the slotted queueing engine at each
offered load instead of through ``Scheme.mc_grid`` -- one ``MCReport``
per (grid point x load level), latency percentiles in ``extra``.

Specs WITHOUT a serving config serialize exactly as before (the key is
omitted when ``None``), so every pre-PR-6 ``spec_hash`` and store
address survives.

Knobs:

``loads``
    Offered load sweep, as fractions of the cluster's aggregate service
    capacity ``lambda_sum`` (0.85 = jobs arrive at 85% of what the
    cluster can serve).  In closed loop, load = clients per worker.
``job_units_dist``
    Per-job unit counts: ``"fixed"`` (every job is exactly N units) or
    ``"geometric"`` (mean N, heavy-ish tail).  N comes from the spec.
``slots`` / ``slot_dt`` / ``warmup_frac``
    Horizon, slot width in seconds (``None`` = auto: ~40 slots per
    pooled job service time), and the warmup fraction excluded from
    metrics.
``deadline_slo``
    SLO deadline in multiples of the pooled ideal sojourn ``N /
    lambda_sum`` (scale-free across grid points); ``None`` disables
    SLO-miss accounting.
``admission``
    ``"queue"`` rejects only on buffer overflow; ``"deadline"`` also
    rejects jobs whose predicted sojourn (backlog / lambda_sum) already
    exceeds the deadline -- load shedding instead of late completions.
``max_queue_jobs`` / ``exchange_every``
    Buffer capacity (jobs, per trial) and the rebalance period (slots)
    for exchange-class dispatch policies.
``backend``
    The queueing engine (``SERVING_BACKENDS``): ``"numpy"`` = the exact
    slotted oracle loop on the host, ``"torch"`` = the slot-step engine on
    a torch device (the reference's ``"jax"`` role; the reference's name
    is not registered here).  The key is OMITTED from ``to_dict`` at the default, so every
    pre-backend spec hash and store address survives; the default also
    defers to ``$REPRO_SERVING_BACKEND`` at resolution time
    (``resolve_backend``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

from .arrivals import get_arrival, list_arrivals

_ADMISSIONS = ("queue", "deadline")
_UNIT_DISTS = ("fixed", "geometric")

# auto slot_dt: this many slots per pooled job service time N/lambda_sum
AUTO_SLOTS_PER_JOB = 40.0


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The arrival/queueing axis as one hashable value."""

    loads: Tuple[float, ...] = (0.5, 0.8)
    arrival: str = "poisson"
    arrival_params: Tuple[Tuple[str, Any], ...] = ()
    job_units_dist: str = "fixed"
    slots: int = 1000
    slot_dt: Optional[float] = None
    warmup_frac: float = 0.25
    deadline_slo: Optional[float] = None
    admission: str = "queue"
    max_queue_jobs: int = 64
    exchange_every: int = 1
    backend: str = "numpy"

    def __post_init__(self):
        object.__setattr__(self, "loads",
                           tuple(float(x) for x in self.loads))
        if isinstance(self.arrival_params, Mapping):
            items = self.arrival_params.items()
        else:
            items = tuple(self.arrival_params)
        object.__setattr__(self, "arrival_params",
                           tuple(sorted((str(k), v) for k, v in items)))
        if not self.loads or any(x <= 0 for x in self.loads):
            raise ValueError("loads must be a non-empty tuple of positive "
                             "offered-load fractions")
        if self.job_units_dist not in _UNIT_DISTS:
            raise ValueError(f"job_units_dist must be one of {_UNIT_DISTS}; "
                             f"got {self.job_units_dist!r}")
        if self.admission not in _ADMISSIONS:
            raise ValueError(f"admission must be one of {_ADMISSIONS}; "
                             f"got {self.admission!r}")
        if self.admission == "deadline" and self.deadline_slo is None:
            raise ValueError("admission='deadline' needs deadline_slo")
        if self.deadline_slo is not None and self.deadline_slo <= 0:
            raise ValueError("deadline_slo must be positive")
        if int(self.slots) <= 0:
            raise ValueError("slots must be positive")
        if self.slot_dt is not None and float(self.slot_dt) <= 0:
            raise ValueError("slot_dt must be positive (or None for auto)")
        if not 0.0 <= float(self.warmup_frac) < 1.0:
            raise ValueError("warmup_frac must be in [0, 1)")
        if int(self.max_queue_jobs) <= 0:
            raise ValueError("max_queue_jobs must be positive")
        if int(self.exchange_every) <= 0:
            raise ValueError("exchange_every must be positive")
        # fail at construction, not mid-run: unknown arrival names/params
        # raise KeyError listing the registry (validate_backend discipline)
        get_arrival(self.arrival, **self.arrival_params_dict)
        # same discipline for the engine name; the device is an
        # execution argument, resolved when the sweep runs
        from .backends import SERVING_BACKENDS
        SERVING_BACKENDS.get(self.backend)

    def resolve_backend(self) -> str:
        """The engine this config runs on: the explicit field, with the
        ``"numpy"`` default deferring to ``$REPRO_SERVING_BACKEND``."""
        from .backends import resolve_serving_backend
        return resolve_serving_backend(self.backend)

    @property
    def arrival_params_dict(self) -> Dict[str, Any]:
        return dict(self.arrival_params)

    def build_arrival(self):
        return get_arrival(self.arrival, **self.arrival_params_dict)

    # -- serialization (the dict is the hash input; ``backend`` is
    # omitted at its default so pre-backend hashes survive) -----------------

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "loads": [float(x) for x in self.loads],
            "arrival": self.arrival,
            "arrival_params": self.arrival_params_dict,
            "job_units_dist": self.job_units_dist,
            "slots": int(self.slots),
            "slot_dt": (None if self.slot_dt is None
                        else float(self.slot_dt)),
            "warmup_frac": float(self.warmup_frac),
            "deadline_slo": (None if self.deadline_slo is None
                             else float(self.deadline_slo)),
            "admission": self.admission,
            "max_queue_jobs": int(self.max_queue_jobs),
            "exchange_every": int(self.exchange_every),
        }
        if self.backend != "numpy":
            d["backend"] = self.backend
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServingConfig":
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - allowed
        if unknown:
            raise KeyError(f"unknown serving key(s) {sorted(unknown)}; "
                           f"allowed {sorted(allowed)} (registered arrival "
                           f"processes: {list_arrivals()})")
        kwargs = dict(d)
        if "loads" in kwargs:
            kwargs["loads"] = tuple(kwargs["loads"])
        if "arrival_params" in kwargs:
            kwargs["arrival_params"] = tuple(kwargs["arrival_params"]
                                             .items())
        return cls(**kwargs)


__all__ = ["ServingConfig", "AUTO_SLOTS_PER_JOB"]
