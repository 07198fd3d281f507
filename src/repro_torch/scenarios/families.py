"""The two PR-4 scenario families, ported behind the registry
(the port of ``repro.scenarios.families``).

``uniform_random`` is the paper's Section-7 family -- one K-worker
``HetSpec.uniform_random`` draw per ``(mu, sigma2, seed)`` point, the
heterogeneity draw pinned per point so the grid is a pure value.
``explicit`` carries literal rate vectors (measured clusters,
adversarial layouts).

Both serialize in the exact PR-4 ``ScenarioGrid`` shape (no ``family``
key), so every pre-refactor ``spec_hash`` and results-store address is
preserved, and the numpy engine consumes the same ``HetSpec`` rows in
the same order -- seed-for-seed bit-identity is structural.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from ..core.types import HetSpec

from .base import ScenarioFamily, check_keys, register_family

ScenarioPoint = Tuple[float, float, int]        # (mu, sigma2, seed)


@register_family("uniform_random")
@dataclasses.dataclass(frozen=True)
class UniformRandomScenario(ScenarioFamily):
    """Paper Section-7 points: ``(mu, sigma2, seed)`` triples, each
    materializing as ``HetSpec.uniform_random(K, mu, sigma2,
    default_rng(seed))``."""

    K: int
    points: Tuple[ScenarioPoint, ...]

    def __post_init__(self):
        pts = tuple((float(mu), float(s2), int(seed))
                    for mu, s2, seed in self.points)
        if not pts:
            raise ValueError("uniform_random needs at least one point")
        if int(self.K) <= 0:
            raise ValueError("points grids need K > 0")
        object.__setattr__(self, "points", pts)
        object.__setattr__(self, "K", int(self.K))

    def __len__(self) -> int:
        return len(self.points)

    def specs(self) -> List[HetSpec]:
        return [HetSpec.uniform_random(self.K, mu, s2,
                                       np.random.default_rng(seed))
                for mu, s2, seed in self.points]

    def to_dict(self) -> Dict[str, Any]:
        # PR-4 ScenarioGrid shape, no "family" key: hash-preserving
        return {"K": self.K, "points": [list(p) for p in self.points]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "UniformRandomScenario":
        check_keys(d, frozenset({"K", "points"}), frozenset(),
                   "uniform_random")
        return cls(K=int(d["K"]),
                   points=tuple(tuple(p) for p in d["points"]))


@register_family("explicit")
@dataclasses.dataclass(frozen=True)
class ExplicitScenario(ScenarioFamily):
    """Literal ``HetSpec`` rate vectors; ``K`` is inferred and shared."""

    explicit: Tuple[HetSpec, ...]

    def __post_init__(self):
        exp = tuple(self.explicit)
        if not exp:
            raise ValueError("explicit needs at least one HetSpec")
        for h in exp:
            if not isinstance(h, HetSpec):
                raise TypeError(f"explicit entries must be HetSpec; "
                                f"got {type(h).__name__}")
        if any(h.K != exp[0].K for h in exp):
            raise ValueError("explicit HetSpecs must share K")
        object.__setattr__(self, "explicit", exp)

    @property
    def K(self) -> int:
        return self.explicit[0].K

    def __len__(self) -> int:
        return len(self.explicit)

    def specs(self) -> List[HetSpec]:
        return list(self.explicit)

    def to_dict(self) -> Dict[str, Any]:
        # PR-4 ScenarioGrid shape, no "family" key: hash-preserving
        return {"explicit": [h.to_dict() for h in self.explicit]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExplicitScenario":
        check_keys(d, frozenset({"explicit"}), frozenset(), "explicit")
        return cls(explicit=tuple(HetSpec.from_dict(h)
                                  for h in d["explicit"]))


__all__ = ["ScenarioPoint", "UniformRandomScenario", "ExplicitScenario"]
