"""``LiveConfig``: the live-execution axis of an ExperimentSpec.  The
port's own copy of ``repro.control.config``.

A frozen, JSON-lossless value (the ``ServingConfig`` discipline) that
turns a Monte-Carlo experiment into a *live* one: set
``ExperimentSpec(execution="live", live=LiveConfig(...))`` and every
scheme task runs through the asyncio control plane
(``repro_torch.control.coordinator``) over the configured transport --
real message round-trips, real matmul shards on the torch device,
measured wall-clock coordination cost -- instead of through
``Scheme.mc_grid``.  One ``MCReport`` per grid point, ``spec.trials``
live episodes each, with the telemetry timeline in
``extra["control_plane"]``.

``to_dict`` is the reference's key for key: it is hashed into the spec,
so a live spec has the reference's address.  The device the payload runs
on is not a field: like every other axis of the port it is
``run_experiment``'s ``device=``.

Specs WITHOUT live execution serialize exactly as before (both the
``execution`` and ``live`` keys are omitted at their defaults), so
every pre-live ``spec_hash`` and store address survives.

Knobs:

``transport`` / ``transport_params``
    A registered transport (``repro_torch.control.list_transports()``)
    and its constructor params -- ``("flaky", {"drop": 0.2, "seed":
    7})`` injects message loss to exercise retries.
``time_scale`` / ``target_wall_s``
    Wall seconds per model second.  Service times are drawn per unit
    from the worker's Exp(1/lambda_k) model clock and realized as wall
    time through this factor; ``None`` auto-scales each grid point so
    one episode's expected compute is ``target_wall_s``.
``unit_rows`` / ``unit_dim``
    The real payload: unit u is the row block ``A[u*rows:(u+1)*rows]``
    of one shared ``A @ x`` matmul, held on the torch device
    (``repro_torch.control.compute``), so a live run computes an actual
    sharded product while the drawn service clock governs pacing.
``timeout_s`` / ``retries`` / ``backoff``
    Coordinator-side RPC discipline: each request waits ``timeout_s *
    backoff**attempt`` for its reply and is re-sent up to ``retries``
    times; a worker that exhausts the budget is declared lost and its
    leftover units are reassigned.
``poll_s``
    Progress-poll period while waiting on a round (also the worker
    liveness probe).
``kill_worker`` / ``kill_after_frac``
    Fault injection: silently halt worker ``kill_worker`` after that
    fraction of the episode's expected wall time (``None`` = no fault).
    Part of the config -- and hence the spec hash -- so fault runs are
    content-addressed like any other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

from .transport import get_transport, list_transports


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """The live-execution axis as one hashable value."""

    transport: str = "inproc"
    transport_params: Tuple[Tuple[str, Any], ...] = ()
    time_scale: Optional[float] = None
    target_wall_s: float = 1.0
    unit_rows: int = 4
    unit_dim: int = 64
    timeout_s: float = 1.0
    retries: int = 2
    backoff: float = 1.5
    poll_s: float = 0.05
    kill_worker: Optional[int] = None
    kill_after_frac: float = 0.25

    def __post_init__(self):
        if isinstance(self.transport_params, Mapping):
            items = self.transport_params.items()
        else:
            items = tuple(self.transport_params)
        object.__setattr__(self, "transport_params",
                           tuple(sorted((str(k), v) for k, v in items)))
        if self.time_scale is not None and float(self.time_scale) <= 0:
            raise ValueError("time_scale must be positive (or None for "
                             "auto)")
        if float(self.target_wall_s) <= 0:
            raise ValueError("target_wall_s must be positive")
        if int(self.unit_rows) <= 0 or int(self.unit_dim) <= 0:
            raise ValueError("unit_rows and unit_dim must be positive")
        if float(self.timeout_s) <= 0 or float(self.poll_s) <= 0:
            raise ValueError("timeout_s and poll_s must be positive")
        if int(self.retries) < 0:
            raise ValueError("retries must be >= 0")
        if float(self.backoff) < 1.0:
            raise ValueError("backoff must be >= 1")
        if self.kill_worker is not None and int(self.kill_worker) < 0:
            raise ValueError("kill_worker must be a worker index or None")
        if not 0.0 < float(self.kill_after_frac) <= 1.0:
            raise ValueError("kill_after_frac must be in (0, 1]")
        # fail at construction, not mid-run: unknown transport names or
        # params raise KeyError listing the registry
        get_transport(self.transport, **self.transport_params_dict)

    @property
    def transport_params_dict(self) -> Dict[str, Any]:
        return dict(self.transport_params)

    def build_transport(self):
        return get_transport(self.transport, **self.transport_params_dict)

    def resolve_time_scale(self, expected_model_s: float) -> float:
        """Wall seconds per model second for a grid point whose expected
        compute span is ``expected_model_s`` model seconds."""
        if self.time_scale is not None:
            return float(self.time_scale)
        return float(self.target_wall_s) / max(expected_model_s, 1e-9)

    # -- serialization (every knob appears: the dict is the hash input) -----

    def to_dict(self) -> Dict[str, Any]:
        return {
            "transport": self.transport,
            "transport_params": self.transport_params_dict,
            "time_scale": (None if self.time_scale is None
                           else float(self.time_scale)),
            "target_wall_s": float(self.target_wall_s),
            "unit_rows": int(self.unit_rows),
            "unit_dim": int(self.unit_dim),
            "timeout_s": float(self.timeout_s),
            "retries": int(self.retries),
            "backoff": float(self.backoff),
            "poll_s": float(self.poll_s),
            "kill_worker": (None if self.kill_worker is None
                            else int(self.kill_worker)),
            "kill_after_frac": float(self.kill_after_frac),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LiveConfig":
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - allowed
        if unknown:
            raise KeyError(f"unknown live key(s) {sorted(unknown)}; "
                           f"allowed {sorted(allowed)} (registered "
                           f"transports: {list_transports()})")
        kwargs = dict(d)
        if "transport_params" in kwargs:
            kwargs["transport_params"] = tuple(kwargs["transport_params"]
                                               .items())
        return cls(**kwargs)


__all__ = ["LiveConfig"]
