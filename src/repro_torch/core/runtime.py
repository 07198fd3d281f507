"""Semantic heterogeneous-cluster runtime: real PyTorch math, virtual
clocks.  The port of ``repro.core.runtime``; the pool and the schedulers
are host numpy, copied line for line, so a run's clocks and unit
movements are the reference's bits.

One card cannot produce wall-clock heterogeneity physically.  Instead we
run the *actual* computation (per-unit gradients, real optimizer updates
-- full numerics) while the latency dimension is driven by the paper's
stochastic model (exponential service times, the same Gamma/Binomial
conditioning as the scalar ``simulate`` path).  This is
strictly stronger than a timing mock-up: every scheduling policy must also
produce bitwise-consistent learning (work conservation => the per-step
gradient sum is policy-independent), which the tests assert.

``VirtualWorkerPool`` can also replay *measured* service-time traces, so
the same runtime drives real-cluster traces when available.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..optim.adamw import tree_map
from .exchange import Assignment, MasterScheduler


@dataclasses.dataclass
class FailureEvent:
    worker: int
    iteration: int        # worker dies at the start of this epoch (0-based)


class VirtualWorkerPool:
    """K workers with true rates; executes one epoch of an Assignment.

    ``traces`` (optional, shape (K, E)) replays measured per-epoch service
    rates instead of the stationary ``rates``: epoch e runs at column
    ``e % E``, so a finite trace wraps around.  ``rates`` still names the
    nominal speeds the scheduler may be told about.
    """

    def __init__(self, rates: Sequence[float], seed: int = 0,
                 unit_cost: float = 1.0,
                 traces: Optional[np.ndarray] = None,
                 rng: Optional[np.random.Generator] = None):
        self.rates = np.asarray(rates, dtype=np.float64)
        self.K = self.rates.size
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.unit_cost = float(unit_cost)   # scales service times uniformly
        self.traces = None
        if traces is not None:
            traces = np.asarray(traces, dtype=np.float64)
            if traces.ndim != 2 or traces.shape[0] != self.K:
                raise ValueError(f"traces must be (K={self.K}, E); "
                                 f"got {traces.shape}")
            if np.any(traces <= 0) or not np.all(np.isfinite(traces)):
                raise ValueError("trace rates must be finite and positive")
            self.traces = traces
        self.epoch = 0
        # per-worker finish/stop times of the last epoch (inf for idle or
        # dead workers) -- what straggler-wait accounting reads back
        self.last_t_k = np.full(self.K, np.inf)

    def rates_at(self, epoch: int) -> np.ndarray:
        """True service rates in effect during ``epoch``."""
        if self.traces is None:
            return self.rates
        return self.traces[:, epoch % self.traces.shape[1]]

    def finish_times(self, sizes: Sequence[int],
                     dead: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole-queue finish times for one epoch: worker k completes its
        ``sizes[k]`` units at Gamma(sizes[k], rate_k) -- the cover-rule
        primitive (coded schemes race full replicated queues).  Advances
        the epoch counter like ``run_epoch``; idle/dead workers get inf."""
        rates = self.rates_at(self.epoch)
        self.epoch += 1
        sizes = np.asarray(sizes, dtype=np.int64)
        dead = np.zeros(self.K, bool) if dead is None else dead
        t_k = np.full(self.K, np.inf)
        busy = (sizes > 0) & ~dead
        if busy.any():
            t_k[busy] = self.rng.gamma(shape=sizes[busy],
                                       scale=self.unit_cost / rates[busy])
        self.last_t_k = t_k
        return t_k

    def run_epoch(self, assignment: Assignment,
                  dead: Optional[np.ndarray] = None
                  ) -> tuple[float, np.ndarray]:
        """Returns (elapsed, done_counts).  wait_all => run to completion;
        otherwise stop at the first completion flag (work-exchange epoch)."""
        rates = self.rates_at(self.epoch)
        self.epoch += 1
        sizes = assignment.sizes
        dead = np.zeros(self.K, bool) if dead is None else dead
        t_k = np.full(self.K, np.inf)
        busy = (sizes > 0) & ~dead
        self.last_t_k = t_k
        if not busy.any():
            return 0.0, np.zeros(self.K, dtype=np.int64)
        t_k[busy] = self.rng.gamma(shape=sizes[busy],
                                   scale=self.unit_cost / rates[busy])
        done = np.zeros(self.K, dtype=np.int64)
        if assignment.wait_all:
            done[busy] = sizes[busy]
            return float(np.max(t_k[busy])), done
        finisher = int(np.argmin(t_k))
        t_star = float(t_k[finisher])
        done[finisher] = sizes[finisher]
        others = busy.copy()
        others[finisher] = False
        if others.any():
            n = np.maximum(sizes[others] - 1, 0)
            p = np.clip(t_star / t_k[others], 0.0, 1.0)
            done[others] = self.rng.binomial(n, p)
        return t_star, done


@dataclasses.dataclass
class StepMetrics:
    loss: float
    t_comp: float
    iterations: int
    n_comm: int
    units: int
    failed_workers: List[int]


class HetTrainRuntime:
    """Drives a MasterScheduler over real per-unit gradient computations.

    ``grad_fn(params, unit_id) -> (loss, grads)`` must be pure; the runtime
    accumulates gradients in the order units complete (any order is valid
    by work conservation, but float sums in another order differ in their
    last bits) and applies ``update_fn(params, opt_state, grads_mean) ->
    (params, opt_state)`` once per step.
    """

    def __init__(self, pool: VirtualWorkerPool,
                 grad_fn: Callable, update_fn: Callable,
                 scheduler_factory: Callable[[Sequence[int]], MasterScheduler],
                 failures: Sequence[FailureEvent] = ()):
        self.pool = pool
        self.grad_fn = grad_fn
        self.update_fn = update_fn
        self.scheduler_factory = scheduler_factory
        self.failures = list(failures)

    def step(self, params, opt_state, unit_ids: Sequence[int]):
        sched = self.scheduler_factory(unit_ids)
        dead = np.zeros(self.pool.K, dtype=bool)
        grads_sum = None
        loss_sum = 0.0
        processed: set[int] = set()
        failed: List[int] = []
        epoch = 0
        while not sched.finished:
            assignment = sched.next_assignment()
            if assignment is None:
                break
            for ev in self.failures:
                if ev.iteration == epoch and not dead[ev.worker]:
                    dead[ev.worker] = True
                    failed.append(ev.worker)
            elapsed, done = self.pool.run_epoch(assignment, dead)
            # real computation for exactly the processed prefix of each queue
            for k in range(self.pool.K):
                for u in assignment.queues[k][: int(done[k])]:
                    if u in processed:
                        raise AssertionError(f"unit {u} processed twice")
                    processed.add(u)
                    loss, g = self.grad_fn(params, u)
                    loss_sum += float(loss)
                    grads_sum = g if grads_sum is None else _tree_add(grads_sum, g)
            sched.report(done, elapsed)
            for k in np.nonzero(dead)[0]:
                sched.mark_failed(int(k))
            epoch += 1
        assert processed == set(unit_ids), "work conservation violated"
        n = len(unit_ids)
        grads_mean = _tree_scale(grads_sum, 1.0 / n)
        params, opt_state = self.update_fn(params, opt_state, grads_mean)
        return params, opt_state, StepMetrics(
            loss=loss_sum / n, t_comp=sched.t_comp,
            iterations=sched.iterations, n_comm=sched.n_comm,
            units=n, failed_workers=failed)


def _tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def _tree_scale(a, s):
    return tree_map(lambda x: x * s, a)
