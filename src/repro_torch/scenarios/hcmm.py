"""HCMM-style load sweeps: load-optimized ``het_mds`` operating points
(the port of ``repro.scenarios.hcmm``).

"Coded Computation over Heterogeneous Clusters" (Reisizadeh et al.,
HCMM) and heterogeneous-worker coded computation (Sun et al.) study the
regime our ``het_mds`` scheme models: each worker gets a coded load
``l_k`` proportional to its rate with aggregate redundancy ``r``, and
the run completes when the finished workers' loads cover ``N``.  The
axis that moves the optimal redundancy in this unit model is the
*per-worker load* ``N / K``: at a few units per worker, straggler noise
is large relative to the work (Var[T_k]/E[T_k]^2 ~ 1/l_k) and extra
redundancy lets the early finishers cover for the tail (r* ~ 1.25 at
~4 units/worker in the paper's Section-7 population); at hundreds of
units per worker the noise averages out and every duplicated unit just
delays the cover (r* -> 1).

``hcmm_sweep`` materializes that axis: one heterogeneity draw per load
point (pinned derived seeds) and a per-point Monte-Carlo redundancy
optimization (eq.-6-style candidate sweep, also pinned -- the family
stays a pure value) that emits the load-optimized ``het_mds`` operating
point for each scenario:

    fam = HCMMSweepScenario(K=50, mu=50.0, sigma2=50.0**2/6, seed=3)
    fam.specs()               # one HetSpec per load point
    fam.point_N(g)            # the point's total work  loads[g] * K
    fam.operating_points()    # [(HetSpec, N_g, r*), ...]
    fam.het_mds_params(g)     # {"redundancy": r*} for scheme_spec()
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from ..core.types import HetSpec

from .base import ScenarioFamily, check_keys, register_family

# namespace tags: per-point heterogeneity draws and the optimizer's rng
# stream are independent of each other and of other families
_DRAW_STREAM = 0x4C32
_OPT_STREAM = 0x4C33


@register_family("hcmm_sweep")
@dataclasses.dataclass(frozen=True)
class HCMMSweepScenario(ScenarioFamily):
    """Per-worker-load sweep with per-point MC-optimized ``het_mds``
    redundancy (the HCMM granularity axis)."""

    K: int
    mu: float
    sigma2: float
    seed: int
    loads: Tuple[int, ...] = (4, 16, 64, 256)    # units per worker
    redundancies: Tuple[float, ...] = (1.0, 1.05, 1.1, 1.25, 1.5, 2.0)
    opt_trials: int = 128

    def __post_init__(self):
        loads = tuple(int(x) for x in self.loads)
        rs = tuple(float(r) for r in self.redundancies)
        if not loads or any(x <= 0 for x in loads):
            raise ValueError("loads must be positive units-per-worker")
        if not rs or any(r < 1.0 for r in rs):
            raise ValueError("redundancy candidates must be >= 1")
        if int(self.K) <= 0:
            raise ValueError("hcmm_sweep needs K > 0")
        if int(self.opt_trials) <= 0:
            raise ValueError("opt_trials must be > 0")
        object.__setattr__(self, "K", int(self.K))
        object.__setattr__(self, "mu", float(self.mu))
        object.__setattr__(self, "sigma2", float(self.sigma2))
        object.__setattr__(self, "seed", int(self.seed))
        object.__setattr__(self, "loads", loads)
        object.__setattr__(self, "redundancies", rs)
        object.__setattr__(self, "opt_trials", int(self.opt_trials))

    def __len__(self) -> int:
        return len(self.loads)

    def point_N(self, g: int) -> int:
        """Total work at load point ``g``: ``loads[g] * K`` units."""
        return self.loads[g] * self.K

    def specs(self) -> List[HetSpec]:
        """One pinned Section-7 draw per load point (derived seeds, so
        adding/removing points never perturbs the others)."""
        return [HetSpec.uniform_random(
                    self.K, self.mu, self.sigma2,
                    np.random.default_rng([self.seed, _DRAW_STREAM, g]))
                for g in range(len(self.loads))]

    def optimal_redundancy(self, g: int) -> float:
        """MC-optimized ``het_mds`` redundancy at load point ``g``
        (pinned rng; eq.-6-style candidate sweep over
        ``redundancies``)."""
        from ..core.schemes import HetMDSScheme
        het = self.specs()[g]
        N = self.point_N(g)
        best = (self.redundancies[0], np.inf)
        for r in self.redundancies:
            rng = np.random.default_rng(
                [self.seed, _OPT_STREAM, g, int(round(r * 1000))])
            ts = HetMDSScheme(redundancy=r)._cover_times(
                het, N, self.opt_trials, rng)
            mean_t = float(ts.mean())
            if mean_t < best[1]:
                best = (r, mean_t)
        return best[0]

    def operating_points(self) -> List[Tuple[HetSpec, int, float]]:
        """The load-optimized ``het_mds`` operating point per scenario:
        ``(HetSpec, N, redundancy*)`` triples."""
        return [(het, self.point_N(g), self.optimal_redundancy(g))
                for g, het in enumerate(self.specs())]

    def het_mds_params(self, g: int) -> Dict[str, Any]:
        """Constructor params for ``scheme_spec("het_mds", ...)`` at the
        point's load-optimized redundancy."""
        return {"redundancy": self.optimal_redundancy(g)}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "family": "hcmm_sweep",
            "K": self.K,
            "mu": self.mu,
            "sigma2": self.sigma2,
            "seed": self.seed,
            "loads": list(self.loads),
            "redundancies": list(self.redundancies),
            "opt_trials": self.opt_trials,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "HCMMSweepScenario":
        check_keys(d, frozenset({"K", "mu", "sigma2", "seed"}),
                   frozenset({"loads", "redundancies", "opt_trials"}),
                   "hcmm_sweep")
        kwargs: Dict[str, Any] = {}
        if "opt_trials" in d:
            kwargs["opt_trials"] = int(d["opt_trials"])
        for k in ("loads", "redundancies"):
            if k in d:
                kwargs[k] = tuple(d[k])
        return cls(K=int(d["K"]), mu=float(d["mu"]),
                   sigma2=float(d["sigma2"]), seed=int(d["seed"]), **kwargs)


__all__ = ["HCMMSweepScenario"]
