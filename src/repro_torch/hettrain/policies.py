"""Every registered scheme as an epoch-assignment training policy: the
port of ``repro.hettrain.policies`` (host numpy, copied line for line).

One executor drives one optimizer step's worth of *virtual* scheduling
-- which worker processed which units, when -- against any scheme the
registry can produce a scheduler for:

* **exchange protocols** (``make_scheduler`` -> ``MasterScheduler``):
  work_exchange known/unknown, trace_replay, and the static fixed /
  uniform assignments (threshold 1e9 => one wait-all epoch);
* **cover protocols** (``make_scheduler`` -> ``CoverScheduler``,
  flagged ``cover``): gradient_coded races whole replicated queues and
  completes at coverage;
* **simulate-only schemes** (oracle, mds, het_mds, hedged): no id-aware
  protocol, so the runner times steps through ``scheme.simulate`` at the
  nominal rates instead (stamped ``nominal_rates_only`` under drift).

The executor never touches gradients: it returns *who did what, when*
(``groups``) plus the timing ledger, and the gradient engine runs one
canonical-order dispatch per step regardless -- which is exactly why the
optimizer trajectory is bit-identical across policies.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.runtime import VirtualWorkerPool


@dataclasses.dataclass
class StepStats:
    """One virtual step's scheduling ledger (no gradients)."""

    t_comp: float                  # virtual wall-clock for the step
    iterations: int                # assignment epochs
    n_comm: int                    # units moved (eq. 2) / shipped redundancy
    straggler_wait: float          # sum over workers of idle-at-barrier time
    groups: List[Tuple[int, List[int]]]   # (worker, credited units) in
                                          # completion order

    @property
    def wait_frac(self) -> float:
        """Fraction of total worker-time spent idle at barriers."""
        K = max(len({w for w, _ in self.groups}), 1)
        denom = K * max(self.t_comp, 1e-12)
        return float(min(self.straggler_wait / denom, 1.0))


def policy_mode(scheme) -> str:
    """``"scheduler"`` (exchange or cover protocol) or ``"simulate"``."""
    if getattr(scheme, "cover_scheduler", False):
        return "scheduler"
    try:
        scheme.make_scheduler([0], rates=np.ones(1))
        return "scheduler"
    except NotImplementedError:
        return "simulate"


def run_virtual_step(sched, pool: VirtualWorkerPool,
                     unit_ids: Sequence[int],
                     failures: Sequence[int] = (),
                     loader=None) -> StepStats:
    """Drive one scheduler to completion over the pool's virtual clocks.

    ``failures`` are worker ids dead from this step's first epoch on
    (their leftover units are reassigned / covered).  ``loader`` (a
    ``HetShardedLoader``) gets prefetch + ownership-touch calls so
    re-fetch traffic is counted without materializing batches.  Asserts
    exact unit conservation: the credited groups partition the step.
    """
    K = pool.K
    dead = np.zeros(K, dtype=bool)
    for w in failures:
        dead[int(w)] = True
    processed: set = set()
    groups: List[Tuple[int, List[int]]] = []
    wait = 0.0

    if getattr(sched, "cover", False):
        a = sched.next_assignment()
        if loader is not None:
            for k in range(K):
                loader.prefetch(k, a.queues[k])
        t_k = pool.finish_times(a.sizes, dead)
        for w in np.nonzero(dead)[0]:
            sched.mark_failed(int(w))
        t_done, done, cover_groups = sched.resolve(t_k)
        for w, units in cover_groups:
            processed.update(units)
            groups.append((w, list(units)))
        # workers whose whole queue finished before the cover instant
        # idle until the master declares completion
        early = np.isfinite(t_k) & (t_k <= t_done)
        wait = float(np.sum(t_done - t_k[early]))
    else:
        epoch = 0
        while not sched.finished:
            a = sched.next_assignment()
            if a is None:
                break
            if epoch == 0 and loader is not None:
                for k in range(K):
                    loader.prefetch(k, a.queues[k])
            elapsed, done = pool.run_epoch(a, dead)
            for k in range(K):
                todo = a.queues[k][: int(done[k])]
                if todo:
                    if loader is not None:
                        loader.touch(k, todo)
                    for u in todo:
                        assert u not in processed, f"unit {u} done twice"
                    processed.update(todo)
                    groups.append((k, list(todo)))
            if a.wait_all:
                # barrier epoch: everyone waits for the slowest
                t_k = pool.last_t_k
                fin = np.isfinite(t_k)
                if fin.any():
                    wait += float(np.sum(elapsed - t_k[fin]))
            sched.report(done, elapsed)
            for w in np.nonzero(dead)[0]:
                sched.mark_failed(int(w))
            epoch += 1

    assert processed == set(int(u) for u in unit_ids), \
        "work conservation violated"
    return StepStats(t_comp=float(sched.t_comp),
                     iterations=int(sched.iterations),
                     n_comm=int(sched.n_comm), straggler_wait=wait,
                     groups=groups)


def build_scheduler(scheme, unit_ids: Sequence[int],
                    rates: np.ndarray, estimator=None,
                    threshold_frac: Optional[float] = None):
    """Uniform ``make_scheduler`` call (known schemes ignore the
    estimator; unknown-heterogeneity schemes carry it across steps)."""
    return scheme.make_scheduler(unit_ids, rates=np.asarray(rates, float),
                                 estimator=estimator,
                                 threshold_frac=threshold_frac)


__all__ = ["StepStats", "policy_mode", "run_virtual_step",
           "build_scheduler"]
