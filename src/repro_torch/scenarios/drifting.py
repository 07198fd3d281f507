"""Drifting-heterogeneity scenarios: rates that evolve across rounds
(the port of ``repro.scenarios.drifting``).

The paper evaluates every scheme on rates drawn once and held fixed; its
central claim -- work exchange tracks the work-conservation bound even
when heterogeneity is *unknown and estimated online* -- is only really
stressed when the rates move underneath the estimator.  This family
generates per-exchange-round service-rate schedules in two shapes:

``kind="ar1"``
    Log-rate AR(1): ``x_0 = 0``, ``x_{r+1} = rho x_r + sigma eps``,
    realized rates ``lambda_k exp(x_{r,k})`` -- smooth mean-reverting
    drift (thermal throttling, gradual co-tenancy pressure).

``kind="regime"``
    Two-state Markov switching per worker: a healthy worker drops to
    ``regime_scale`` of its nominal rate with probability
    ``regime_prob`` per round and recovers with probability
    ``recover_prob`` -- abrupt degradation (VM migration, noisy
    neighbours, power caps).

Round 0 always runs at the nominal rates (the base heterogeneity draw),
so the "known heterogeneity" variant genuinely knows the initial truth
and then watches it move; rounds beyond ``rounds`` hold the last row.
The schedule reaches the engines through the ``rate_schedule`` argument
of ``Scheme.mc_grid`` / the sampler backends: service draws follow the
schedule, assignment shares stay nominal (known) or online-estimated
(unknown).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from ..core.types import HetSpec

from .base import ScenarioFamily, check_keys, register_family
from .families import ScenarioPoint

KINDS = ("ar1", "regime")
# namespace tag for the schedule's rng stream, so the drift draws are
# independent of the base heterogeneity draw pinned by the same seed
_SCHED_STREAM = 0xD81F7


@register_family("drifting")
@dataclasses.dataclass(frozen=True)
class DriftingScenario(ScenarioFamily):
    """AR(1) / regime-switch rate evolution over exchange rounds."""

    K: int
    points: Tuple[ScenarioPoint, ...]       # (mu, sigma2, seed) base draws
    kind: str = "ar1"
    rounds: int = 48
    rho: float = 0.9
    drift_sigma: float = 0.12
    regime_prob: float = 0.08
    regime_scale: float = 0.45
    recover_prob: float = 0.25

    def __post_init__(self):
        pts = tuple((float(mu), float(s2), int(seed))
                    for mu, s2, seed in self.points)
        if not pts:
            raise ValueError("drifting needs at least one point")
        if int(self.K) <= 0:
            raise ValueError("drifting grids need K > 0")
        if self.kind not in KINDS:
            raise ValueError(f"unknown drift kind {self.kind!r}; "
                             f"have {KINDS}")
        if int(self.rounds) < 1:
            raise ValueError("rounds must be >= 1")
        if not 0.0 <= float(self.rho) < 1.0:
            raise ValueError("rho must be in [0, 1)")
        if not 0.0 < float(self.regime_scale) <= 1.0:
            raise ValueError("regime_scale must be in (0, 1]")
        for name in ("drift_sigma", "regime_prob", "recover_prob"):
            if float(getattr(self, name)) < 0.0:
                raise ValueError(f"{name} must be >= 0")
        object.__setattr__(self, "points", pts)
        object.__setattr__(self, "K", int(self.K))
        object.__setattr__(self, "rounds", int(self.rounds))

    def __len__(self) -> int:
        return len(self.points)

    def specs(self) -> List[HetSpec]:
        """Nominal rates: the base draw == the schedule's round 0."""
        return [HetSpec.uniform_random(self.K, mu, s2,
                                       np.random.default_rng(seed))
                for mu, s2, seed in self.points]

    def rate_schedules(self) -> np.ndarray:
        """``(G, rounds, K)`` realized service rates, pinned per point."""
        out = np.empty((len(self.points), self.rounds, self.K))
        for g, ((mu, s2, seed), het) in enumerate(zip(self.points,
                                                      self.specs())):
            rng = np.random.default_rng([seed, _SCHED_STREAM])
            base = het.lambdas
            if self.kind == "ar1":
                x = np.zeros(self.K)
                for r in range(self.rounds):
                    out[g, r] = base * np.exp(x)
                    x = (self.rho * x
                         + self.drift_sigma * rng.standard_normal(self.K))
            else:                               # regime switching
                throttled = np.zeros(self.K, dtype=bool)
                for r in range(self.rounds):
                    out[g, r] = base * np.where(throttled,
                                                self.regime_scale, 1.0)
                    u = rng.uniform(size=self.K)
                    throttled = np.where(throttled,
                                         u >= self.recover_prob,
                                         u < self.regime_prob)
        return np.maximum(out, 1e-9)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "family": "drifting",
            "K": self.K,
            "points": [list(p) for p in self.points],
            "kind": self.kind,
            "rounds": self.rounds,
            "rho": float(self.rho),
            "drift_sigma": float(self.drift_sigma),
            "regime_prob": float(self.regime_prob),
            "regime_scale": float(self.regime_scale),
            "recover_prob": float(self.recover_prob),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DriftingScenario":
        check_keys(d, frozenset({"K", "points"}),
                   frozenset({"kind", "rounds", "rho", "drift_sigma",
                              "regime_prob", "regime_scale",
                              "recover_prob"}), "drifting")
        kwargs = {k: d[k] for k in ("kind", "rounds", "rho", "drift_sigma",
                                    "regime_prob", "regime_scale",
                                    "recover_prob") if k in d}
        return cls(K=int(d["K"]),
                   points=tuple(tuple(p) for p in d["points"]), **kwargs)


__all__ = ["KINDS", "DriftingScenario"]
