"""Unit-level work-exchange master protocol (Algorithms 1 & 3), id-aware:
the port's own copy of ``repro.core.exchange`` (host numpy), line for
line, so assignments, logs and ``n_comm`` are the reference's.

The sampler backends are the fast count-based Monte-Carlo engines for
the paper's figures; this module is the *executable* protocol the
training runtimes drive.  It tracks concrete unit ids so that

  * real computations (per-microbatch gradients) can be attached to units,
  * N_comm is counted by actual unit movement (a worker keeping its own
    leftover costs nothing -- eq. 1),
  * failures/elasticity reduce to returning a worker's unfinished ids to
    the pool and re-running the same assignment rule.

The master is deliberately synchronous-at-iteration-boundaries, mirroring
the paper's stop-flag protocol adapted to SPMD unit granularity.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .assignment import largest_remainder_round
from .estimator import CumulativeRateEstimator, RateEstimator


@dataclasses.dataclass
class IterationLog:
    assignment_sizes: np.ndarray
    done_counts: np.ndarray
    elapsed: float
    moved_units: int          # N_comm contribution of this epoch


@dataclasses.dataclass
class Assignment:
    """Per-worker ordered unit queues plus the master's wait mode."""
    queues: List[List[int]]
    wait_all: bool            # final phase below the cutting threshold

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(q) for q in self.queues], dtype=np.int64)


class MasterScheduler:
    """Work-exchange master (Algorithm 1 when rates given, Algorithm 3 when not)."""

    def __init__(self, unit_ids: Sequence[int], K: int,
                 rates: Optional[np.ndarray] = None,
                 estimator: Optional[RateEstimator] = None,
                 threshold_frac: float = 0.01,
                 storage_cap_frac: Optional[float] = 1.0,
                 prior_rate: float = 1.0):
        self.K = K
        self.N = len(unit_ids)
        self.known = rates is not None
        self.rates = None if rates is None else np.asarray(rates, np.float64)
        self.estimator = estimator or CumulativeRateEstimator(K, prior_rate)
        self.threshold = threshold_frac * self.N / K
        self.cap = (None if self.known or storage_cap_frac is None
                    else int(np.ceil(storage_cap_frac * self.N / K)))
        self.pool: List[int] = list(unit_ids)       # unassigned units
        self.holding: List[List[int]] = [[] for _ in range(K)]  # leftover ids
        self.alive = np.ones(K, dtype=bool)
        self.done_ids: List[int] = []
        self.logs: List[IterationLog] = []
        self.n_comm = 0
        self._finished = False

    # -- assignment -------------------------------------------------------

    def _rule_sizes(self, n_rem: int) -> np.ndarray:
        rates = self.rates if self.known else self.estimator.rates()
        rates = np.where(self.alive, rates, 0.0)
        sizes = largest_remainder_round(rates, n_rem)
        if self.cap is not None:
            sizes = np.minimum(sizes, self.cap)   # Alg. 3 storage cap; carry rest
        return sizes

    def next_assignment(self) -> Optional[Assignment]:
        """Build the next epoch's queues, or None if all units are done."""
        n_rem = len(self.pool) + sum(len(h) for h in self.holding)
        if n_rem == 0:
            self._finished = True
            return None
        wait_all = n_rem <= self.threshold
        sizes = self._rule_sizes(n_rem)
        if sizes.sum() == 0:     # degenerate rounding; push everything out
            sizes = largest_remainder_round(self.alive.astype(float), n_rem)
        # Workers first keep their own leftover (free), then the master ships
        # surplus leftover back to the pool and pool units to deficit workers.
        queues: List[List[int]] = [[] for _ in range(self.K)]
        moved = 0
        for k in range(self.K):
            keep = self.holding[k][: int(sizes[k])]
            spill = self.holding[k][int(sizes[k]):]
            queues[k] = list(keep)
            self.pool.extend(spill)
            self.holding[k] = []
        for k in range(self.K):
            deficit = int(sizes[k]) - len(queues[k])
            if deficit > 0:
                ship = self.pool[:deficit]
                del self.pool[:deficit]
                queues[k].extend(ship)
                if self.logs:          # eq. (2): initial assignment is free
                    moved += len(ship)
        self.n_comm += moved
        self._pending = Assignment(queues=queues, wait_all=wait_all)
        self._pending_moved = moved
        return self._pending

    # -- feedback ---------------------------------------------------------

    def report(self, done_counts: Sequence[int], elapsed: float) -> None:
        """Workers processed the first ``done_counts[k]`` units of their queue."""
        a = self._pending
        done_counts = np.asarray(done_counts, dtype=np.int64)
        for k in range(self.K):
            q = a.queues[k]
            d = int(done_counts[k])
            if d > len(q):
                raise ValueError(f"worker {k} reported {d} > assigned {len(q)}")
            self.done_ids.extend(q[:d])
            self.holding[k] = q[d:]
        self.estimator.update(done_counts, elapsed)
        self.logs.append(IterationLog(a.sizes, done_counts, elapsed,
                                      self._pending_moved))
        if len(self.done_ids) == self.N:
            self._finished = True

    # -- fault tolerance / elasticity --------------------------------------

    def mark_failed(self, k: int) -> None:
        """Worker k died: return its unfinished units; stop assigning to it."""
        self.alive[k] = False
        self.pool.extend(self.holding[k])
        self.holding[k] = []

    def revive(self, k: int) -> None:
        self.alive[k] = True

    # -- stats --------------------------------------------------------------

    @property
    def finished(self) -> bool:
        return self._finished

    @property
    def iterations(self) -> int:
        return len(self.logs)

    @property
    def t_comp(self) -> float:
        return float(sum(l.elapsed for l in self.logs))

    def estimated_rates(self) -> np.ndarray:
        return self.rates if self.known else self.estimator.rates()


class CoverScheduler:
    """One-shot replicated master: coded redundancy instead of exchange.

    The registry scheduler surface for ``gradient_coded`` (fractional
    repetition, Tandon-style): every unit is replicated ``s + 1`` times
    across disjoint worker groups, the single epoch dispatches the
    replicated queues, and the run completes at the earliest instant the
    fully-finished workers jointly *cover* all N units -- up to ``s``
    stragglers (or failures) tolerated with zero coordination rounds.

    Unlike ``MasterScheduler`` the feedback is a whole-queue finish-time
    vector (``VirtualWorkerPool.finish_times``), resolved via
    ``resolve(t_k)``; executors branch on the ``cover`` attribute.
    ``n_comm`` is the shipped redundancy (sizes.sum() - N, eq. 2's
    analogue for coded schemes).
    """

    cover = True

    def __init__(self, unit_ids: Sequence[int], K: int, s: int = 1):
        from .coded import GradientCoding
        self.N = len(unit_ids)
        self.K = int(K)
        self.s = int(s)
        K_used = self.K - self.K % (self.s + 1)   # FR needs (s+1) | K
        if K_used < self.s + 1:
            raise ValueError(f"need >= {self.s + 1} workers for s={self.s}")
        ids = list(unit_ids)
        owners = GradientCoding(K=K_used, s=self.s).assignment(self.N)
        self.queues: List[List[int]] = [[ids[i] for i in o] for o in owners]
        self.queues += [[] for _ in range(self.K - K_used)]
        self.n_comm = int(sum(len(q) for q in self.queues) - self.N)
        self.dead = np.zeros(self.K, dtype=bool)
        self._dispatched = False
        self._finished = False
        self._t_comp = 0.0

    def next_assignment(self) -> Optional[Assignment]:
        if self._dispatched:
            return None
        self._dispatched = True
        return Assignment(queues=[list(q) for q in self.queues],
                          wait_all=True)

    def resolve(self, t_k: np.ndarray):
        """Walk finishers in time order until every unit is covered.

        Returns ``(t_done, done_counts, groups)`` where ``groups`` is the
        per-worker list of units whose *first* replica to finish came
        from that worker -- exactly one credited replica per unit, so the
        union is the full step (work conserved)."""
        t_k = np.asarray(t_k, dtype=np.float64)
        order = np.argsort(t_k, kind="stable")
        covered: set = set()
        done = np.zeros(self.K, dtype=np.int64)
        groups: List[tuple] = []
        t_done = None
        for w in order:
            if not np.isfinite(t_k[w]) or not self.queues[w]:
                continue
            fresh = [u for u in self.queues[w] if u not in covered]
            covered.update(fresh)
            done[w] = len(fresh)
            if fresh:
                groups.append((int(w), fresh))
            if len(covered) == self.N:
                t_done = float(t_k[w])
                break
        if t_done is None:
            raise RuntimeError(
                f"coverage impossible: {len(covered)}/{self.N} units "
                f"reachable (more than s={self.s} workers lost?)")
        self._finished = True
        self._t_comp = t_done
        return t_done, done, groups

    def mark_failed(self, k: int) -> None:
        self.dead[int(k)] = True

    @property
    def finished(self) -> bool:
        return self._finished

    @property
    def iterations(self) -> int:
        return 1 if self._finished else 0

    @property
    def t_comp(self) -> float:
        return self._t_comp
