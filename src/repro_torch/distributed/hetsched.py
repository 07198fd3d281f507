"""Heterogeneity-aware training: the paper's schemes as policies.
The port of ``repro.distributed.hetsched``.

The unit of work is a microbatch; the K workers are data-parallel rank
groups.  Policies:

  equal_static        -- uniform split, wait for all (the naive baseline)
  het_static          -- Section 5.1: proportional split, wait for all
  work_exchange       -- Section 5.2: known rates, iterative reassignment
  work_exchange_online-- Section 6: rates estimated online (+ estimator
                         variants: cumulative / EMA / Bayesian)
  gradient_coded      -- Section 3 baseline translated to training:
                         fractional-repetition gradient coding, any K-s
                         replies recover the exact batch gradient

Every policy resolves through ``SCHEME_REGISTRY`` to an executable
scheduler -- exchange protocols to ``MasterScheduler``, gradient coding
to ``CoverScheduler`` -- and the shared virtual-step executor
(``repro_torch.hettrain.policies.run_virtual_step``) drives it over the
pool's virtual clocks.  Gradients run through the unit-group engine
(``repro_torch.hettrain.engine``): ONE canonical-order ``grad_sum`` per
optimizer step, so the parameter trajectory is *bit-identical* across
policies by work conservation.  Time is virtual (exponential service
model, a literal trace matrix or a measured-trace corpus by name).

The step runs on the params' device (the kernels on the card, their
plain versions on the CPU), and ``AdamW.update`` works in place: the
params given to ``train`` are the tensors trained.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.estimator import make_estimator
from ..core.runtime import VirtualWorkerPool
from ..core.schemes import get_scheme
from ..data.pipeline import HetShardedLoader, UnitStore
from ..hettrain.engine import ScanGradEngine, tree_bytes
from ..hettrain.policies import run_virtual_step
from ..optim import AdamW
from ..optim.adamw import tree_leaves, tree_map

# Training policy names are scheme-registry names/aliases (equal_static ->
# uniform, het_static -> fixed, work_exchange_online -> unknown-het work
# exchange, gradient_coded -> the CoverScheduler path).
POLICIES = ("equal_static", "het_static", "work_exchange",
            "work_exchange_online", "gradient_coded")


@dataclasses.dataclass
class StepReport:
    step: int
    loss: float
    t_virtual: float
    iterations: int
    n_comm_units: int
    refetch_tokens: int
    grad_bytes: float


class HetTrainer:
    """Drives one of the paper's policies over real PyTorch training."""

    def __init__(self, model, opt: AdamW, rates: Sequence[float],
                 store: UnitStore, policy: str = "work_exchange",
                 units_per_step: int = 32, seed: int = 0,
                 estimator_kind: str = "cumulative",
                 coded_stragglers: int = 1,
                 threshold_frac: float = 0.05,
                 compressor=None,
                 traces: Optional[np.ndarray] = None,
                 trace_corpus: Optional[str] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.model = model
        self.opt = opt
        self.rates = np.asarray(rates, dtype=np.float64)
        self.K = self.rates.size
        self.policy = policy
        self.units_per_step = units_per_step
        self.store = store
        self.loader = HetShardedLoader(store, self.K)
        # trace-driven pool: realized epochs run at measured per-epoch
        # rates (a literal (K, E) matrix, or a results/traces corpus by
        # name) while every policy keeps scheduling by the nominal
        # ``rates`` -- the same scheduler-sees-nominal split as the
        # trace_corpus scenario family
        if trace_corpus is not None:
            if traces is not None:
                raise ValueError("give either traces= or trace_corpus=, "
                                 "not both")
            from ..scenarios.traces import load_corpus
            traces = load_corpus(trace_corpus).window(self.K)
        self.pool = VirtualWorkerPool(self.rates, seed=seed, traces=traces)
        self.estimator_kind = estimator_kind
        self.coded_stragglers = coded_stragglers
        self.threshold_frac = threshold_frac
        self.compressor = compressor
        self.engine = ScanGradEngine(model, store)
        self._persistent_estimator = None
        self._next_unit = 0

    # -- scheduler construction per policy ---------------------------------

    def _make_scheduler(self, unit_ids):
        """Resolve the policy through SCHEME_REGISTRY and let the scheme
        build its executable master protocol (exchange or cover)."""
        if self.policy == "work_exchange_online":
            if self._persistent_estimator is None:
                self._persistent_estimator = make_estimator(
                    self.estimator_kind, self.K)
        params = ({"s": self.coded_stragglers}
                  if self.policy == "gradient_coded" else {})
        scheme = get_scheme(self.policy, **params)
        return scheme.make_scheduler(unit_ids, rates=self.rates,
                                     estimator=self._persistent_estimator,
                                     threshold_frac=self.threshold_frac)

    # -- one optimizer step --------------------------------------------------

    def _schedule(self, failures: Sequence[int]):
        """Run the next step's schedule over the virtual clocks: (its
        unit ids, its ``StepStats``)."""
        unit_ids = list(range(self._next_unit,
                              self._next_unit + self.units_per_step))
        self._next_unit += self.units_per_step
        sched = self._make_scheduler(unit_ids)
        stats = run_virtual_step(sched, self.pool, unit_ids,
                                 failures=failures, loader=self.loader)
        return unit_ids, stats

    def skip(self, failures: Sequence[int] = ()) -> None:
        """Advance past one step without computing it: the virtual
        clocks, the data cursor, the loader's ownership and an online
        estimator move as that step's ``step`` would move them.  A run
        resumed from a checkpoint skips the steps before it, so its later
        steps schedule, and train on, what the uninterrupted run's do."""
        self._schedule(failures)

    def step(self, params, opt_state, step_idx: int,
             failures: Sequence[int] = ()) -> tuple:
        refetch0 = self.loader.refetched_tokens
        unit_ids, stats = self._schedule(failures)
        n = len(unit_ids)
        if self.compressor is None:
            # canonical path: ONE grad_sum over the full sorted step --
            # the gradient sum is policy-independent bitwise
            grads_sum, losses = self.engine.grad_sum(params, unit_ids)
            loss_sum = float(losses.sum())
            grad_bytes = n * tree_bytes(params)
        else:
            # lossy path: the compressor quantizes each worker group's
            # partial sum before "transmission", so the sums follow the
            # realized (worker, units) groups instead
            grads_sum = None
            loss_sum = 0.0
            grad_bytes = 0.0
            for worker, us in stats.groups:
                g, losses = self.engine.grad_sum(params, us)
                loss_sum += float(losses.sum())
                g, nbytes = self.compressor.roundtrip(g, worker)
                grad_bytes += nbytes
                if grads_sum is None:
                    grads_sum = g
                else:
                    for a, b in zip(tree_leaves(grads_sum),
                                    tree_leaves(g)):
                        a.add_(b)
                del g
        # the sums are this step's own float32 trees: divide in place
        grads = tree_map(lambda g: g.div_(n), grads_sum)
        params, opt_state = self.opt.update(grads, opt_state, params)
        report = StepReport(
            step=step_idx, loss=loss_sum / n,
            t_virtual=stats.t_comp, iterations=stats.iterations,
            n_comm_units=stats.n_comm,
            refetch_tokens=self.loader.refetched_tokens - refetch0,
            grad_bytes=grad_bytes)
        return params, opt_state, report

    # -- loop -----------------------------------------------------------------

    def train(self, params, steps: int,
              failures: Optional[Dict[int, Sequence[int]]] = None):
        """``steps`` optimizer steps from a fresh AdamW state.  Returns
        ``(params, opt_state, history)``; ``params`` are the tensors
        passed in, trained in place (as ``train.loop.fit``'s), so pass a
        clone to keep the starting weights."""
        opt_state = self.opt.init(params)
        history: List[StepReport] = []
        for s in range(steps):
            fail = (failures or {}).get(s, ())
            params, opt_state, rep = self.step(params, opt_state, s, fail)
            history.append(rep)
        return params, opt_state, history


__all__ = ["POLICIES", "StepReport", "HetTrainer"]
