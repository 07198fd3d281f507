"""Shared dataclasses for the work-exchange core.

The port's own copy of ``repro.core.types``: ``to_dict`` / ``from_dict``
and ``canonical_hash`` are byte-for-byte the reference's, so a spec
serialized by either package loads in the other with the same hash.

Terminology follows the paper (Attia & Tandon, 2017):
  N        -- total number of work units ("data points")
  K        -- number of workers
  lambdas  -- heterogeneity set, one Poisson service rate per worker
  I        -- number of reassignment iterations (coordination rounds)
  N_comm   -- extra communication: units shipped beyond a worker's leftover
              from the previous assignment (eq. 1-2)
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class HetSpec:
    """Heterogeneity description of a K-worker cluster.

    Value-semantic: two specs with the same rate vector compare equal,
    hash equal, and round-trip losslessly through ``to_dict`` /
    ``from_dict`` (floats survive JSON exactly -- shortest-repr
    round-trip), so a spec can key a dict, live in a set, and address a
    results-store entry (``canonical_hash``).
    """

    lambdas: np.ndarray  # shape (K,), rates > 0 (units/sec)

    def __post_init__(self):
        # always copy: the array is frozen below and must not alias (and
        # thereby freeze) a caller-owned buffer
        lam = np.array(self.lambdas, dtype=np.float64)
        if lam.ndim != 1 or lam.size == 0:
            raise ValueError("lambdas must be a non-empty 1-D array")
        if np.any(lam < 0) or not np.all(np.isfinite(lam)):
            raise ValueError("lambdas must be finite and non-negative")
        lam.setflags(write=False)
        object.__setattr__(self, "lambdas", lam)

    @property
    def K(self) -> int:
        return int(self.lambdas.size)

    @property
    def lambda_sum(self) -> float:
        return float(self.lambdas.sum())

    # -- value semantics ----------------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, HetSpec):
            return NotImplemented
        return (self.lambdas.shape == other.lambdas.shape
                and bool(np.all(self.lambdas == other.lambdas)))

    def __hash__(self) -> int:
        return hash(self._canonical_bytes())

    def _canonical_bytes(self) -> bytes:
        # fixed endianness so the hash is platform-stable
        return self.lambdas.astype(">f8").tobytes()

    def canonical_hash(self) -> str:
        """Stable content hash of the exact float64 rate vector."""
        return hashlib.sha256(self._canonical_bytes()).hexdigest()

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able dict; exact (float -> shortest repr -> same float)."""
        return {"lambdas": [float(x) for x in self.lambdas]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HetSpec":
        return cls(np.asarray(d["lambdas"], dtype=np.float64))

    @staticmethod
    def uniform_random(K: int, mu: float, sigma2: float,
                       rng: np.random.Generator) -> "HetSpec":
        """Paper Section 7: lambda_k ~ Uniform(mu - sqrt(3 sigma^2), mu + sqrt(3 sigma^2)).

        Requires 0 <= sigma2 <= mu^2/3 so rates stay non-negative.
        """
        if not 0 <= sigma2 <= mu * mu / 3 + 1e-12:
            raise ValueError(f"sigma2 must be in [0, mu^2/3]; got {sigma2}")
        half = np.sqrt(3.0 * sigma2)
        lam = rng.uniform(mu - half, mu + half, size=K)
        return HetSpec(np.maximum(lam, 1e-12))


@dataclasses.dataclass
class RunStats:
    """Outcome of one simulated (or real) run of a scheduling policy."""

    t_comp: float              # total computation time (sum over iterations)
    iterations: int            # I, number of reassignment epochs
    n_comm: float              # extra communication in units (eq. 2)
    n_done: np.ndarray         # per-worker totals, shape (K,)
    t_iter: Optional[np.ndarray] = None  # per-iteration durations

    def check_work_conserved(self, N: int) -> None:
        total = int(round(float(self.n_done.sum())))
        if total != N:
            raise AssertionError(
                f"work conservation violated: processed {total} of {N}")


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Knobs of the work-exchange master protocol (Algorithms 1 & 3)."""

    known_heterogeneity: bool = True
    # Cutting threshold (Remark 1): stop reassigning once N_rem <= threshold
    # and wait for all workers. The paper default is 0.01 * N/K.
    threshold_frac: float = 0.01     # of N/K
    # Storage cap per worker for the unknown-het variant (Section 6): N/K.
    storage_cap_frac: Optional[float] = 1.0   # of N/K; None = uncapped
    max_iterations: int = 10_000
