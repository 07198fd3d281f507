"""Declarative experiment specs: the whole study as one value.  The port
of ``repro.experiments.spec``.

The paper's headline results are grid sweeps -- schemes x (mu, sigma^2)
scenario panels x N x trials -- and every related-work direction
(HCMM-style load optimization, per-worker coded allocation sweeps) has
the same shape.  ``ExperimentSpec`` captures that shape declaratively:

    spec = ExperimentSpec(
        name="fig5",
        grid=ScenarioGrid(K=50, points=[(mu, mu * mu / 6, int(mu))
                                        for mu in (10, 20, 50, 100)]),
        schemes=(scheme_spec("work_exchange"),
                 scheme_spec("mds", opt_trials=64)),
        N=1_000_000, trials=20, seed=1234)

The scenario axis is pluggable (``repro_torch.scenarios``): ``grid``
accepts any registered ``ScenarioFamily``.

Specs are plain values: serializable to/from JSON losslessly (floats
survive by shortest-repr round-trip), hashable via a canonical content
hash (``spec_hash``), and therefore able to key the content-addressed
results store (``repro_torch.experiments.store``).  Execution knobs that
change the sampled numbers -- backend, device count, seeds -- are part
of the spec and hence of the hash: one hash, one set of numbers.  A spec
serializes and hashes exactly as the reference's, so the port reads the
reference's store entries at their addresses.

``serving=`` attaches the streaming-arrival axis
(``repro_torch.serving.ServingConfig``), ``execution="live"`` with
``live=`` the live control plane (``repro_torch.control.LiveConfig``).
At their defaults the keys of both axes are omitted from serialization,
as in the reference.

``repro_torch.experiments.plan`` compiles a spec into an execution
``Plan``; ``repro_torch.experiments.engine`` runs the plan.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from ..control.config import LiveConfig
from ..core.types import HetSpec
from ..hettrain.config import TrainConfig
from ..serving.config import ServingConfig
from ..scenarios import (ExplicitScenario, ScenarioFamily, ScenarioPoint,
                         UniformRandomScenario, scenario_from_dict)

SPEC_VERSION = 1


class ScenarioGrid:
    """Constructor facade over the two original scenario families.

    ``ScenarioGrid(K=, points=)`` builds a ``uniform_random`` family,
    ``ScenarioGrid(explicit=)`` an ``explicit`` one, returning the
    registered family instances that carry the behaviour.
    ``ScenarioGrid.from_dict`` deserializes *any* registered family
    (``repro_torch.scenarios.scenario_from_dict``), including the
    key-less original shapes; unknown family names or unknown keys raise
    ``KeyError`` listing the registered families.
    """

    def __new__(cls, K: int = 0,
                points: Tuple[ScenarioPoint, ...] = (),
                explicit: Tuple[HetSpec, ...] = ()):
        if bool(tuple(points)) == bool(tuple(explicit)):
            raise ValueError("ScenarioGrid needs exactly one of points= "
                             "or explicit=")
        if points:
            return UniformRandomScenario(K=K, points=tuple(points))
        return ExplicitScenario(explicit=tuple(explicit))

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> ScenarioFamily:
        return scenario_from_dict(d)


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One scheme task: registry name + constructor params + report key.

    ``params`` is stored as a sorted ``(key, value)`` tuple so the spec
    stays hashable; build instances with :func:`scheme_spec` to pass
    params as keyword arguments.  ``key`` names the task's row in the
    result (defaults to the scheme name -- give explicit keys when the
    same scheme appears twice with different params, e.g. a threshold
    sweep).  ``seed`` overrides the experiment seed for this task; every
    task draws from its own fresh ``default_rng(seed)``, so adding or
    reordering tasks never perturbs another task's numbers.
    """

    scheme: str
    params: Tuple[Tuple[str, Any], ...] = ()
    key: Optional[str] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.params, Mapping):
            items = self.params.items()
        else:
            items = tuple(self.params)
        object.__setattr__(self, "params",
                           tuple(sorted((str(k), v) for k, v in items)))

    @property
    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    @property
    def report_key(self) -> str:
        return self.key if self.key is not None else self.scheme

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"scheme": self.scheme}
        if self.params:
            d["params"] = self.params_dict
        if self.key is not None:
            d["key"] = self.key
        if self.seed is not None:
            d["seed"] = int(self.seed)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SchemeSpec":
        return cls(scheme=d["scheme"], params=tuple(d.get("params",
                                                          {}).items()),
                   key=d.get("key"), seed=d.get("seed"))


def scheme_spec(scheme: str, *, key: Optional[str] = None,
                seed: Optional[int] = None, **params) -> SchemeSpec:
    """Ergonomic ``SchemeSpec`` constructor: params as kwargs."""
    return SchemeSpec(scheme=scheme, params=tuple(params.items()), key=key,
                      seed=seed)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A complete declarative experiment.

    ``backend=None`` means "the port's default sampler backend
    (``cuda``)", resolved at compile time; ``devices`` is ``1``, an int,
    or ``"auto"``, and compiles to 1: no backend of the port has a
    multi-device executor yet.  The *resolved* spec is what the store
    hashes.  The card the numbers are computed on is an execution
    argument (``run_experiment(..., device=)``), not a spec field.

    ``panel="fused"`` runs the batch-MC tasks through the fused
    whole-panel dispatcher (``repro_torch.core.schemes.mc_grid_panel``):
    the work-exchange known/unknown pair of the panel becomes ONE
    ``we_rounds`` launch on the ``cuda`` backend, every other task keeps
    its own per-task stream and stays bit-identical to ``"per_scheme"``.
    The key is omitted from serialization at the ``"per_scheme"``
    default.

    ``training`` attaches the heterogeneous-training axis
    (``repro_torch.hettrain.TrainConfig``): every scheme task then runs
    as an epoch-assignment policy over real gradients -- ``N`` becomes
    units (microbatches) per optimizer step, ``trials`` the independent
    virtual-time realizations of the one shared trajectory, and each
    report row carries the loss curve, per-step ``T_comp`` and
    straggler-wait fractions in ``extra["training"]``.  ``None`` (the
    default) serializes with the key omitted.

    ``serving`` attaches a streaming-arrival axis
    (``repro_torch.serving.ServingConfig``): every scheme task then runs
    as a dispatch policy through the slotted queueing engine at each
    offered load, one report row per (grid point x load level) with the
    latency percentiles in ``extra``.  ``None`` (the default) serializes
    with the key omitted.

    ``execution="live"`` routes every scheme task through the asyncio
    control plane (``repro_torch.control``) instead of Monte Carlo: real
    transport messages, real matmul shards on ``run_experiment``'s
    device, ``trials`` live episodes per grid point, measured ``T_comp``
    in the same MCReport shape (plus ``extra["control_plane"]``).
    ``live`` carries the transport/pacing/fault knobs (``LiveConfig``;
    defaults apply when ``execution="live"`` with ``live=None``).  Both
    keys are omitted from serialization at their defaults -- "mc" and
    ``None`` -- so every pre-live spec hash and store address is
    unchanged.
    """

    name: str
    grid: ScenarioFamily
    schemes: Tuple[SchemeSpec, ...]
    N: int
    trials: int
    seed: int = 0
    backend: Optional[str] = None
    devices: Union[int, str] = 1
    serving: Optional[ServingConfig] = None
    execution: str = "mc"
    live: Optional[LiveConfig] = None
    panel: str = "per_scheme"
    training: Optional[TrainConfig] = None
    version: int = SPEC_VERSION

    def __post_init__(self):
        if not isinstance(self.grid, ScenarioFamily):
            raise TypeError(f"grid must be a registered ScenarioFamily "
                            f"(or built via ScenarioGrid); got "
                            f"{type(self.grid).__name__}")
        if self.serving is not None and not isinstance(self.serving,
                                                       ServingConfig):
            raise TypeError(f"serving must be a ServingConfig or None; "
                            f"got {type(self.serving).__name__}")
        if self.execution not in ("mc", "live"):
            raise ValueError(f"execution must be 'mc' or 'live'; "
                             f"got {self.execution!r}")
        if self.live is not None and not isinstance(self.live, LiveConfig):
            raise TypeError(f"live must be a LiveConfig or None; "
                            f"got {type(self.live).__name__}")
        if self.execution == "live":
            if self.serving is not None:
                raise ValueError("execution='live' and serving= are "
                                 "mutually exclusive axes")
            if self.live is None:
                object.__setattr__(self, "live", LiveConfig())
        elif self.live is not None:
            raise ValueError("live= requires execution='live'")
        if self.panel not in ("per_scheme", "fused"):
            raise ValueError(f"panel must be 'per_scheme' or 'fused'; "
                             f"got {self.panel!r}")
        if self.panel == "fused" and (self.serving is not None
                                      or self.execution != "mc"):
            raise ValueError("panel='fused' applies to batch MC only; "
                             "drop serving= / execution='live'")
        if self.training is not None:
            if not isinstance(self.training, TrainConfig):
                raise TypeError(f"training must be a TrainConfig or None; "
                                f"got {type(self.training).__name__}")
            if self.serving is not None or self.execution != "mc":
                raise ValueError("training= and serving= / "
                                 "execution='live' are mutually exclusive "
                                 "axes")
            if self.panel != "per_scheme":
                raise ValueError("training= runs per-scheme; drop "
                                 "panel='fused'")
        object.__setattr__(self, "schemes", tuple(self.schemes))
        if not self.schemes:
            raise ValueError("ExperimentSpec needs at least one scheme")
        keys = [s.report_key for s in self.schemes]
        if len(set(keys)) != len(keys):
            dupes = sorted({k for k in keys if keys.count(k) > 1})
            raise ValueError(f"duplicate scheme report keys {dupes}; give "
                             f"distinct key= values")
        if isinstance(self.devices, str) and self.devices != "auto":
            raise ValueError(f"devices must be an int or 'auto'; "
                             f"got {self.devices!r}")
        if self.N <= 0 or self.trials <= 0:
            raise ValueError("N and trials must be positive")

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "version": int(self.version),
            "name": self.name,
            "grid": self.grid.to_dict(),
            "schemes": [s.to_dict() for s in self.schemes],
            "N": int(self.N),
            "trials": int(self.trials),
            "seed": int(self.seed),
            "backend": self.backend,
            "devices": self.devices,
        }
        if self.serving is not None:
            # key omitted when absent: pre-serving hashes stay valid
            d["serving"] = self.serving.to_dict()
        if self.execution != "mc":
            # both live keys omitted at defaults: pre-live hashes survive
            d["execution"] = self.execution
            d["live"] = self.live.to_dict()
        if self.panel != "per_scheme":
            # key omitted at the default: pre-panel hashes survive
            d["panel"] = self.panel
        if self.training is not None:
            # key omitted when absent: pre-training hashes stay valid
            d["training"] = self.training.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        serving = d.get("serving")
        live = d.get("live")
        training = d.get("training")
        return cls(name=d["name"], grid=ScenarioGrid.from_dict(d["grid"]),
                   schemes=tuple(SchemeSpec.from_dict(s)
                                 for s in d["schemes"]),
                   N=int(d["N"]), trials=int(d["trials"]),
                   seed=int(d.get("seed", 0)), backend=d.get("backend"),
                   devices=d.get("devices", 1),
                   serving=(None if serving is None
                            else ServingConfig.from_dict(serving)),
                   execution=d.get("execution", "mc"),
                   live=(None if live is None
                         else LiveConfig.from_dict(live)),
                   panel=d.get("panel", "per_scheme"),
                   training=(None if training is None
                             else TrainConfig.from_dict(training)),
                   version=int(d.get("version", SPEC_VERSION)))

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    # -- content addressing -------------------------------------------------

    def canonical_json(self) -> str:
        """Key-sorted, whitespace-free JSON: the hashing preimage."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def spec_hash(self) -> str:
        """sha256 of the canonical JSON -- the store address.  Covers
        every field, execution knobs included: an unchanged hash promises
        the stored numbers are what a re-run would produce."""
        return hashlib.sha256(
            self.canonical_json().encode("utf-8")).hexdigest()

    def replace(self, **changes) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)


__all__ = [
    "SPEC_VERSION", "ScenarioGrid", "ScenarioFamily", "SchemeSpec",
    "scheme_spec", "ExperimentSpec",
]
