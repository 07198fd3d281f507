"""Scheme-driven training studies: one grid task -> MCReport rows.  The
port of ``repro.hettrain.runner``.

``run_training_grid`` runs one scheme task of a training study (the
reference's experiment executor calls it once per scheme task of a spec
with ``training=TrainConfig(...)``).

Two decoupled computations per task:

1. **The optimizer trajectory** -- real gradients through the unit-group
   ``ScanGradEngine``, one canonical-order ``grad_sum`` per step over
   that step's ``N`` units, on ``device``.  Work conservation makes the
   per-step gradient sum policy-independent, so the trajectory is
   computed ONCE per task and shared by every grid point and trial; any
   two scheme tasks of the same spec produce bit-identical loss curves
   (pinned by tests).
2. **Virtual time** -- per grid point x trial, the scheme's scheduler
   (exchange / cover protocol) or ``simulate`` fallback replays the
   same per-step unit sets over a fresh ``VirtualWorkerPool``,
   producing T_comp, epochs, N_comm, straggler-wait fractions and
   refetch traffic.  Drifting / trace grids pace the pool by the
   per-round rate schedule while schedulers keep seeing nominal rates;
   simulate-only schemes run at nominal and are stamped
   ``nominal_rates_only`` (the executor convention).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.estimator import make_estimator
from ..core.runtime import VirtualWorkerPool
from ..core.schemes import MCReport, _report, get_scheme
from ..data.pipeline import HetShardedLoader
from ..device import DEFAULT_DEVICE
from ..optim.adamw import tree_map
from .config import TrainConfig
from .engine import ScanGradEngine
from .policies import build_scheduler, policy_mode, run_virtual_step


def compute_trajectory(training: TrainConfig, N: int,
                       device=DEFAULT_DEVICE):
    """The policy-independent part: loss curve + engine stats.

    Step ``s`` consumes units ``[s*N, (s+1)*N)``; the gradient sum is
    one canonical-order ``grad_sum``, divided by ``N`` (in place) and fed
    to AdamW, which updates in place.  Returns ``(loss_curve, params,
    engine)``.
    """
    model, params = training.build_model(device)
    store = training.build_store()
    opt = training.build_optimizer()
    engine = ScanGradEngine(model, store)
    opt_state = opt.init(params)
    curve: List[float] = []
    for s in range(int(training.steps)):
        unit_ids = range(s * N, (s + 1) * N)
        grads_sum, losses = engine.grad_sum(params, unit_ids)
        grads = tree_map(lambda g: g.div_(N), grads_sum)
        params, opt_state = opt.update(grads, opt_state, params)
        curve.append(float(np.asarray(losses).mean()))
    return curve, params, engine


def _trial_rng(seed: int, g: int, trial: int) -> np.random.Generator:
    """Fresh independent stream per (task seed, grid point, trial)."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=int(seed),
                               spawn_key=(int(g), int(trial))))


def _virtual_trial(scheme, mode: str, het, training: TrainConfig, N: int,
                   store, rng: np.random.Generator,
                   traces: Optional[np.ndarray]) -> Dict[str, Any]:
    """One virtual-time realization of the whole run (all steps)."""
    K = het.K
    pool = VirtualWorkerPool(het.lambdas, rng=rng, traces=traces)
    steps = int(training.steps)
    t_steps = np.empty(steps)
    iters = 0
    n_comm = 0.0
    wait = 0.0
    refetch = 0
    if mode == "scheduler":
        estimator = (make_estimator(training.estimator, K)
                     if getattr(scheme, "known", True) is False else None)
        loader = HetShardedLoader(store, K)
        for s in range(steps):
            unit_ids = list(range(s * N, (s + 1) * N))
            sched = build_scheduler(scheme, unit_ids, het.lambdas,
                                    estimator=estimator,
                                    threshold_frac=training.threshold_frac)
            st = run_virtual_step(sched, pool, unit_ids, loader=loader)
            t_steps[s] = st.t_comp
            iters += st.iterations
            n_comm += st.n_comm
            wait += st.straggler_wait
        refetch = loader.refetched_tokens
    else:
        for s in range(steps):
            rs = scheme.simulate(het, N, pool.rng)
            t_steps[s] = rs.t_comp
            iters += rs.iterations
            n_comm += rs.n_comm
    total = float(t_steps.sum())
    return {"t_steps": t_steps, "t_total": total, "iterations": iters,
            "n_comm": n_comm,
            "wait_frac": wait / (K * max(total, 1e-12)),
            "refetch_tokens": refetch}


def run_training_grid(scheme_name: str, params: Dict[str, Any],
                      het_specs: Sequence, training: TrainConfig,
                      N: int, trials: int, seed: int,
                      rate_schedules: Optional[np.ndarray] = None,
                      device=DEFAULT_DEVICE) -> List[MCReport]:
    """One scheme task of a training spec: a report row per grid point.

    ``N`` is units (microbatches) per optimizer step; ``trials`` is the
    number of independent virtual-time realizations of the one shared
    trajectory, which trains on ``device``.  ``rate_schedules``
    (optional ``(G, R, K)``) paces the pool by measured/drifting
    per-round rates.
    """
    scheme = get_scheme(scheme_name, **params)
    mode = policy_mode(scheme)
    curve, _, engine = compute_trajectory(training, N, device)
    curve_arr = np.asarray(curve)

    reports: List[MCReport] = []
    for g, het in enumerate(het_specs):
        store = training.build_store()
        runs = [_virtual_trial(scheme, mode, het, training, N, store,
                               _trial_rng(seed, g, t),
                               None if rate_schedules is None
                               else rate_schedules[g].T)
                for t in range(int(trials))]
        ts = np.array([r["t_total"] for r in runs])
        its = np.array([r["iterations"] for r in runs], dtype=np.float64)
        cs = np.array([r["n_comm"] for r in runs])
        t_per_step = np.mean(np.stack([r["t_steps"] for r in runs]),
                             axis=0)
        info: Dict[str, Any] = {
            "mode": mode,
            "steps": int(training.steps),
            "units_per_step": int(N),
            "loss_curve": [float(x) for x in curve],
            "final_loss": float(curve[-1]),
            "t_comp_per_step": [float(x) for x in t_per_step],
            "straggler_wait_frac": float(np.mean([r["wait_frac"]
                                                  for r in runs])),
            "refetch_tokens": float(np.mean([r["refetch_tokens"]
                                             for r in runs])),
            "engine": engine.stats(),
        }
        if training.target_loss is not None:
            hit = np.nonzero(curve_arr <= float(training.target_loss))[0]
            if hit.size:
                s_hit = int(hit[0])
                info["steps_to_target"] = s_hit + 1
                # mean over trials of the virtual wall through step s_hit
                info["wall_to_target"] = float(np.mean(
                    [r["t_steps"][: s_hit + 1].sum() for r in runs]))
            else:
                info["steps_to_target"] = -1
                info["wall_to_target"] = -1.0
        rep = _report(scheme.name, ts, its, cs,
                      extra={"grid_point": g, "training": info})
        if rate_schedules is not None and mode == "simulate":
            # the grid drifts but this scheme has no id-aware protocol to
            # follow it: same stamp as the MC executor
            rep.extra["nominal_rates_only"] = 1
        reports.append(rep)
    return reports


__all__ = ["run_training_grid", "compute_trajectory"]
