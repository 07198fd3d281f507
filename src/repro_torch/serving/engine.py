"""The slotted-time serving engine: arrivals in, latency curves out.  The
port of ``repro.serving.engine``, bit for bit: the same draws in the same
order, the same int64 loop.

``simulate_serving`` runs one (scheme, heterogeneity, offered load) cell
as a trials-batched discrete-event approximation, the MC-engine
discipline applied to the arrival plane: all state is ``(trials, Q, K)``
int64 arrays advanced slot by slot with pure numpy, no per-job Python
objects.  Per slot, in order:

1. *rebalance* -- exchange-class policies re-deal every leftover unit
   across workers by a stream deal: active jobs concatenate (admission
   order) into one unit stream, worker k takes the contiguous interval
   between largest-remainder boundaries of the believed rates.  Exactly
   integer-conserving; units a worker gains count into ``n_comm``.
2. *arrivals + admission* -- the arrival process offers jobs; admission
   rejects on buffer overflow and (``admission="deadline"``) on
   predicted sojourn ``(backlog + u) / lambda_sum`` past the deadline.
   Closed-loop clients resubmit ``think_slots`` after completion.
3. *placement* -- the dispatch policy maps each admitted job's units to
   per-worker shares (``repro_torch.serving.policies``).
4. *service* -- each worker serves its FIFO backlog up to an independent
   ``Poisson(lambda_k dt)`` unit budget; under a drifting / trace
   scenario the schedule moves the TRUE rates for every policy (the
   cluster really slows down), while placement still follows nominal
   rates -- or the online ``(served+1)/(busy+1)`` estimates for
   estimate-driven policies.
5. *completion* -- the policy's done criterion fires, sojourn is
   recorded, coded leftovers are purged.

An exact int64 conservation identity (units shipped == served +
cancelled + backlog) is asserted EVERY slot -- a dispatch-policy bug
dies loudly, not as a subtly wrong latency curve.

Metrics (completion-slot >= warmup only) fold into one ``MCReport`` per
cell: ``t_comp`` = mean sojourn (per-trial mean, trials without a single
window completion censored at the horizon), ``iterations`` = completed
jobs, ``n_comm`` = exchanged units, and ``extra`` carries the latency
surface (p50/p95/p99, throughput, goodput, occupancy, queue depth,
reject + SLO-miss rates) -- so serving rows flow through the store, the
CLI, and ``MCReport.to_dict`` untouched.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.schemes import MCReport
from ..core.types import HetSpec
from ..device import DEFAULT_DEVICE, resolve_device

from .config import AUTO_SLOTS_PER_JOB, ServingConfig
from .policies import dispatch_policy, lr_round_rows

__all__ = ["simulate_serving", "run_serving_grid"]

_BIG = np.iinfo(np.int64).max


def simulate_serving(het: HetSpec, scheme_name: str,
                     params: Optional[Dict[str, Any]], cfg: ServingConfig,
                     N: int, load: float, trials: int,
                     rng: np.random.Generator,
                     rate_schedule: Optional[np.ndarray] = None) -> MCReport:
    """One load cell: simulate ``trials`` independent queues and fold the
    latency/throughput surface into an ``MCReport`` (see module docs).

    ``rate_schedule`` is an optional ``(R, K)`` true-rate schedule for
    this grid point (drifting / trace scenarios), stretched uniformly
    over the slot horizon.
    """
    policy = dispatch_policy(scheme_name, dict(params or {}), het, N)
    arrival = cfg.build_arrival()
    T, K, Q, S = int(trials), het.K, int(cfg.max_queue_jobs), int(cfg.slots)
    if T < 1:
        raise ValueError("trials must be >= 1")
    N = int(N)
    lam = het.lambdas
    lam_sum = het.lambda_sum
    dt = (float(cfg.slot_dt) if cfg.slot_dt is not None
          else N / lam_sum / AUTO_SLOTS_PER_JOB)
    warm = int(float(cfg.warmup_frac) * S)
    window_t = (S - warm) * dt
    horizon_t = S * dt
    deadline_t = (None if cfg.deadline_slo is None
                  else float(cfg.deadline_slo) * N / lam_sum)
    jobs_per_slot = float(load) * lam_sum * dt / N
    sched = None
    if rate_schedule is not None:
        sched = np.asarray(rate_schedule, dtype=np.float64)
        if sched.ndim != 2 or sched.shape[1] != K:
            raise ValueError(f"rate_schedule must be (rounds, K={K}); "
                             f"got {sched.shape}")

    # offered demand: open-loop processes precompute the stream, closed
    # loop runs off the resubmission ring
    if arrival.closed_loop:
        counts = np.zeros((T, S), dtype=np.int64)
        resub = np.zeros((T, S + 1), dtype=np.int64)
        resub[:, 0] = arrival.population_for(float(load), K)
        think = int(arrival.think_slots)
    else:
        counts = np.asarray(
            arrival.job_counts(T, S, jobs_per_slot, rng), dtype=np.int64)
        resub, think = None, 0

    # job state, one row per buffer slot
    R = np.zeros((T, Q, K), dtype=np.int64)        # remaining units
    S0 = np.zeros((T, Q, K), dtype=np.int64)       # shipped at placement
    units = np.zeros((T, Q), dtype=np.int64)
    seq = np.zeros((T, Q), dtype=np.int64)         # admission order
    arr_slot = np.zeros((T, Q), dtype=np.int64)
    active = np.zeros((T, Q), dtype=bool)
    aux = np.full((T, Q), -1, dtype=np.int64)      # policy tag (hedged)
    seq_ctr = np.zeros(T, dtype=np.int64)

    # online rate beliefs: units served over busy seconds, prior 1.0
    served_w = np.zeros((T, K), dtype=np.float64)
    busy_w = np.zeros((T, K), dtype=np.float64)
    believed_nominal = np.broadcast_to(lam, (T, K))

    # exact conservation ledger
    shipped_cum = np.zeros(T, dtype=np.int64)
    served_cum = np.zeros(T, dtype=np.int64)
    cancelled_cum = np.zeros(T, dtype=np.int64)

    # measurement-window accumulators
    soj_all: List[np.ndarray] = []
    sum_soj = np.zeros(T, dtype=np.float64)
    completed_w = np.zeros(T, dtype=np.int64)
    completed_full = np.zeros(T, dtype=np.int64)
    goodput_w = np.zeros(T, dtype=np.int64)
    slo_miss = np.zeros(T, dtype=np.int64)
    moved_w = np.zeros(T, dtype=np.float64)
    qd_sum = np.zeros(T, dtype=np.float64)
    served_units_w = np.zeros(T, dtype=np.int64)
    offered = np.zeros(T, dtype=np.int64)
    rejected = np.zeros(T, dtype=np.int64)

    geo_p = 1.0 / max(N, 1)
    # admission fills the lowest free buffer row, so live jobs stay
    # compact at the front: q_hi (high-water mark of rows ever used)
    # bounds every O(Q) pass by the actual concurrency, not the cap
    q_hi = 0
    q_hi_peak = 0
    q_hi_sum = 0
    for s in range(S):
        lam_t = lam
        if sched is not None:
            row = min(s * sched.shape[0] // S, sched.shape[0] - 1)
            lam_t = sched[row]

        # -- 1. rebalance (exchange-class policies) ------------------------
        # ship ONLY surplus (the paper's leftover-reassignment, not a
        # full re-deal): workers holding more backlog than their rate
        # share give up units -- newest jobs first, so the head-of-line
        # job keeps its parallel spread -- and the moved units deal into
        # the deficit workers' contiguous stream intervals (exactly
        # integer-conserving, per job and per trial)
        if (policy.exchanges and s % int(cfg.exchange_every) == 0 and s
                and q_hi):
            Rv, activev, seqv = R[:, :q_hi], active[:, :q_hi], seq[:, :q_hi]
            weights = ((served_w + 1.0) / (busy_w + 1.0)
                       if policy.uses_estimates else believed_nominal)
            b = Rv.sum(axis=1)                        # (T, K) backlogs
            targets = lr_round_rows(weights, b.sum(axis=1))
            surplus = np.clip(b - targets, 0, None)
            deficit = np.clip(targets - b, 0, None)
            if surplus.any():
                key = np.where(activev, seqv, _BIG)
                order = np.argsort(key, axis=1, kind="stable")
                R_ord = np.take_along_axis(Rv, order[:, :, None], axis=1)
                # units queued behind job q on worker k (newer jobs)
                behind = (np.cumsum(R_ord[:, ::-1], axis=1)[:, ::-1]
                          - R_ord)
                rm = np.clip(np.minimum(
                    R_ord, surplus[:, None, :] - behind), 0, None)
                rm_q = rm.sum(axis=2)                 # (T, Qh) moved/job
                end = np.cumsum(rm_q, axis=1)
                start = end - rm_q
                dbounds = np.concatenate(
                    [np.zeros((T, 1), dtype=np.int64),
                     np.cumsum(deficit, axis=1)], axis=1)
                add = np.clip(
                    np.minimum(end[:, :, None], dbounds[:, None, 1:])
                    - np.maximum(start[:, :, None], dbounds[:, None, :-1]),
                    0, None)
                np.put_along_axis(Rv, order[:, :, None], R_ord - rm + add,
                                  axis=1)
                if policy.count_comm and s >= warm:
                    moved_w += add.sum(axis=(1, 2))

        # -- 2+3. arrivals, admission, placement ---------------------------
        n_new = counts[:, s] + (resub[:, s] if resub is not None else 0)
        for j in range(int(n_new.max()) if T else 0):
            cand = n_new > j
            if s >= warm:
                offered += cand
            if cfg.job_units_dist == "geometric":
                u = rng.geometric(geo_p, size=T).astype(np.int64)
            else:
                u = np.full(T, N, dtype=np.int64)
            inactive = ~active
            has_free = inactive.any(axis=1)
            qidx = np.argmax(inactive, axis=1)
            ok = cand & has_free
            if cfg.admission == "deadline":
                pred = (R.sum(axis=(1, 2)) + u) / lam_sum
                ok &= pred <= deadline_t
            rej = cand & ~ok
            if s >= warm:
                rejected += rej
            if resub is not None and s + 1 < S:
                # a bounced closed-loop client retries next slot
                resub[:, s + 1] += rej
            tr = np.nonzero(ok)[0]
            if tr.size == 0:
                continue
            ua = u[tr]
            believed = (((served_w[tr] + 1.0) / (busy_w[tr] + 1.0))
                        if policy.uses_estimates
                        else np.broadcast_to(lam, (tr.size, K)))
            placed = policy.place(ua, believed)
            shares, ptag = (placed if isinstance(placed, tuple)
                            else (placed, None))
            q = qidx[tr]
            R[tr, q] = shares
            S0[tr, q] = shares
            units[tr, q] = ua
            seq[tr, q] = seq_ctr[tr]
            seq_ctr[tr] += 1
            arr_slot[tr, q] = s
            active[tr, q] = True
            aux[tr, q] = -1 if ptag is None else ptag
            shipped_cum[tr] += shares.sum(axis=1)
            q_hi = max(q_hi, int(q.max()) + 1)

        # -- 4. service: per-worker FIFO up to Poisson(lambda_k dt) --------
        cap = rng.poisson(lam_t * dt, size=(T, K)).astype(np.int64)
        Rv, activev = R[:, :q_hi], active[:, :q_hi]
        bk_before = Rv.sum(axis=1)                 # (T, K)
        key = np.where(activev, seq[:, :q_hi], _BIG)
        order = np.argsort(key, axis=1, kind="stable")
        R_ord = np.take_along_axis(Rv, order[:, :, None], axis=1)
        ahead = np.cumsum(R_ord, axis=1) - R_ord
        srv = np.minimum(R_ord, np.clip(cap[:, None, :] - ahead, 0, None))
        np.put_along_axis(Rv, order[:, :, None], R_ord - srv, axis=1)
        srv_k = srv.sum(axis=1)                    # (T, K)
        served_cum += srv_k.sum(axis=1)
        served_w += srv_k
        busy_w += dt * (bk_before > 0)

        # -- 5. completions ------------------------------------------------
        done = policy.done_mask(Rv, S0[:, :q_hi], units[:, :q_hi],
                                activev, aux[:, :q_hi]) & activev
        if done.any():
            if policy.purge:
                cancelled_cum += (Rv * done[:, :, None]).sum(axis=(1, 2))
                Rv[done] = 0
            n_done_t = done.sum(axis=1)
            completed_full += n_done_t
            if s >= warm:
                tidx = np.nonzero(done)[0]
                vals = ((s + 1 - arr_slot[:, :q_hi]) * dt)[done]
                soj_all.append(vals)
                np.add.at(sum_soj, tidx, vals)
                completed_w += n_done_t
                goodput_w += (units[:, :q_hi] * done).sum(axis=1)
                if deadline_t is not None:
                    np.add.at(slo_miss, tidx,
                              (vals > deadline_t + 1e-12).astype(np.int64))
            activev &= ~done
            if resub is not None and s + 1 + think < S:
                resub[:, s + 1 + think] += n_done_t
            # the mark must also SHRINK: after a burst drains, a frozen
            # q_hi keeps every later pass O(peak) instead of O(live) --
            # recompact to the last live row once occupancy halves
            live_rows = activev.any(axis=0)
            if int(live_rows.sum()) < q_hi // 2:
                nz = np.nonzero(live_rows)[0]
                q_hi = int(nz[-1]) + 1 if nz.size else 0

        if s >= warm:
            qd_sum += Rv.sum(axis=(1, 2))
            served_units_w += srv_k.sum(axis=1)
        q_hi_peak = max(q_hi_peak, q_hi)
        q_hi_sum += q_hi

        # -- conservation: exact, every slot -------------------------------
        backlog = Rv.sum(axis=(1, 2))
        if not np.array_equal(shipped_cum,
                              served_cum + cancelled_cum + backlog):
            raise AssertionError(
                f"work conservation violated at slot {s} "
                f"({scheme_name}): shipped {shipped_cum.tolist()} != "
                f"served {served_cum.tolist()} + cancelled "
                f"{cancelled_cum.tolist()} + backlog {backlog.tolist()}")

    soj_pool = (np.concatenate(soj_all) if soj_all
                else np.empty(0, dtype=np.float64))
    censored = int((completed_w == 0).sum())
    per_trial = np.where(completed_w > 0,
                         sum_soj / np.maximum(completed_w, 1), horizon_t)
    if soj_pool.size:
        p50, p95, p99 = (float(x) for x in
                         np.percentile(soj_pool, [50.0, 95.0, 99.0]))
        latency_censored = False
    else:
        # no job completed inside the measurement window: the horizon is
        # only a LOWER BOUND on the true latency, not a measurement --
        # flagged below so knee detection and the CLI can tell a
        # saturated cell from a measured one
        p50 = p95 = p99 = horizon_t
        latency_censored = True
    its = completed_w.astype(np.float64)
    extra: Dict[str, Any] = {
        "serving": 1.0,
        "offered_load": float(load),
        "slot_dt": float(dt),
        "p50": p50, "p95": p95, "p99": p99,
        "throughput_jobs": float(completed_w.mean() / window_t),
        "goodput_units": float(goodput_w.mean() / window_t),
        "occupancy": float(served_units_w.mean() / (lam_sum * window_t)),
        "queue_depth": float(qd_sum.mean() / max(S - warm, 1)),
        "reject_rate": float(rejected.sum() / max(offered.sum(), 1)),
        "completed_jobs": float(completed_full.mean()),
        "units_admitted": float(shipped_cum.mean()),
        "units_served": float(served_cum.mean()),
        "units_cancelled": float(cancelled_cum.mean()),
        "units_backlog": float(R.sum(axis=(1, 2)).mean()),
        # scan-window telemetry: mean/peak high-water mark over slots
        # (the compaction regression test reads these -- a burst that
        # drains must pull the mean well below the peak)
        "q_hi_mean": float(q_hi_sum / max(S, 1)),
        "q_hi_peak": float(q_hi_peak),
    }
    if deadline_t is not None:
        extra["deadline_s"] = float(deadline_t)
        extra["slo_miss_rate"] = float(slo_miss.sum()
                                       / max(completed_w.sum(), 1))
    # censoring telemetry: ``latency_censored`` marks the full fallback
    # (every percentile above is the horizon bound, not a measurement);
    # ``censored_frac`` is the per-trial fraction that completed nothing
    # (partial censoring biases percentiles low -- the slow trials'
    # latencies are the ones missing from the pool)
    extra["latency_censored"] = 1.0 if latency_censored else 0.0
    if censored:
        extra["censored"] = float(censored)
        extra["censored_frac"] = float(censored / T)
    return MCReport(
        scheme=policy.scheme.name, trials=T,
        t_comp=float(per_trial.mean()), t_comp_std=float(per_trial.std()),
        iterations=float(its.mean()), iterations_std=float(its.std()),
        n_comm=float(moved_w.mean()), n_comm_std=float(moved_w.std()),
        extra=extra)


def run_serving_grid(scheme_name: str, params: Optional[Dict[str, Any]],
                     het_specs: Sequence[HetSpec], cfg: ServingConfig,
                     N: int, trials: int, seed: int,
                     rate_schedules: Optional[np.ndarray] = None,
                     backend: Optional[str] = None,
                     device=DEFAULT_DEVICE) -> List[MCReport]:
    """The serving analogue of ``Scheme.mc_grid``: one report per
    (grid point x offered load), loads innermost, ``extra["grid_point"]``
    marking the scenario row.  Each cell draws from its own
    ``default_rng([seed, g, load_index])`` so numbers are independent of
    which other cells run -- the engine seed discipline.

    ``backend`` picks the queueing engine (kwarg > ``cfg.backend`` >
    ``$REPRO_SERVING_BACKEND`` > ``"numpy"``); the ``torch`` backend runs
    every load of a cell as one slot-step loop on ``device``
    (``repro_torch.serving.scan``), the numpy default is this module's
    loop on the host, whatever ``device`` names.  ``device`` (default
    ``"cuda"``, which raises without a card) is resolved on both."""
    from .backends import get_serving_backend, resolve_serving_backend

    dev = resolve_device(device)
    name = resolve_serving_backend(
        backend if backend is not None else cfg.backend)
    sweep = get_serving_backend(name).sweep
    reports: List[MCReport] = []
    for g, het in enumerate(het_specs):
        sched = (None if rate_schedules is None
                 else np.asarray(rate_schedules[g], dtype=np.float64))
        rows = sweep(het, scheme_name, params, cfg, N, trials,
                     int(seed), g, sched, dev)
        for rep in rows:
            rep.extra["grid_point"] = float(g)
        reports.extend(rows)
    return reports
