"""The ``torch`` serving backend: one slot-step loop per load sweep.  The
counterpart of the reference's ``jax`` engine (``repro.serving.scan``, a
jitted ``lax.scan``), as torch ops on an explicit device.

The numpy engine (``repro_torch.serving.engine``) walks slots in a Python
loop, one ``simulate_serving`` call per offered load, on the host.  Here
the per-slot step -- arrivals offered -> deadline admission -> placement
-> surplus-only exchange / purge-on-decode -> FIFO service up to
per-worker Poisson budgets -> completion / SLO accounting -- runs on
``device`` as a fixed sequence of torch ops, and the ``loads`` sweep
rides along as extra trial-block rows: state is ``(B, Q, K)``
int32 / float32 tensors with ``B = len(loads) * trials``, so one loop
over the slots produces the whole load-vs-latency curve of a policy.

What the host does, as the reference does it (the draws' shapes set
their streams, so the shapes stay):

* the per-load arrival counts, each load from its own
  ``default_rng([seed, g, li])`` -- the numpy engine's first draw, so
  both engines see the same offered jobs;
* the per-(slot, row, worker) Poisson service budgets, from
  ``default_rng([seed, g, 2**31 + 1])`` at the bucketed
  ``(S, B, K)`` shape; and the seed of the device generator that draws
  geometric job sizes, from ``default_rng([seed, g, 2**31])``;
* ``Q`` (``max_queue_jobs``), ``K`` (``bucket_cols``), the horizon ``S``
  and the batch ``B`` are padded to pow2 buckets; padded rows have no
  arrivals, padded workers rate 0;
* the slot schedule -- warmup, exchange period, the horizon -- is known
  on the host, so the loop branches on it instead of masking, and walks
  only the ``S`` live slots: a padded slot changes nothing that is read;
* the percentiles, from the integer histogram of completion slot-counts
  (sojourns are exact multiples of ``slot_dt``), with the oracle's math.

The queue is stored physically in FIFO order -- active jobs are a
contiguous prefix, admission appends at ``n_active``, completion
compacts survivors left -- so every FIFO prefix sum is a cumsum over the
queue axis and no slot orders jobs by admission.  Within a slot nothing
is read back to the host: no ``.item()``, no data-dependent shape.  The
loop's only host reads are after it.

Two of the reference's measured shapes of the dispatch stay:

* **dead-state elision**: state nobody reads (coded thresholds, hedged
  mirrors, per-job unit counts under fixed sizing) is not carried, and a
  placement that cannot change from slot to slot (fixed sizes and a
  policy that does not follow online estimates) is computed once;
* **two-tier queue width**, on the CPU: fixed-units sweeps first run
  every row at ``_TIER_Q`` physical queue rows with the TRUE admission
  cap, carry a per-row overflow flag, and rerun exactly the flagged rows
  at full width -- an exact splice (rows are independent and draw
  nothing on the device), pinned bitwise by the tests.  On the CPU a
  pass costs its width, so the narrow pass and a small rerun beat one
  full-width pass; on the card a pass costs its launches, so the tier
  would only add a pass, and one full-width pass runs.

Float sums over the worker axis (the largest-remainder rounding's weight
total) are taken in float64 and rounded once to float32: exact for any
weights within 2**25 of each other, so their order cannot change a bit
and the same inputs give the same integers on the card and on the CPU.

Policies are translated from the same ``DispatchPolicy`` adapters the
numpy loop uses (``_policy_form``).  Every registered scheme has a
device form.  An adapter without one raises ``NotImplementedError``
naming its class: the reference drops such an adapter to the numpy
sweep, which here would run a device request on the host.  Closed-loop
arrivals raise ``ValueError`` (the resubmission ring needs per-slot
completions on the host).

Inside ``repro_torch.core.samplers.grid_sharding`` the padded rows are
made a multiple of D and cut into D blocks, each looped on its own
device with its own generator seed (one ``default_rng([seed, g,
2**31])`` draw of D seeds, as the reference's sharded ``lax.scan`` draws
one stream per device); the host draws stay whole.  With one device the
sweep is the unsplit one.

Correctness contract: the int32 conservation ledger is carried through
the loop and the exact identity (shipped == served + cancelled +
backlog) is asserted on the final ledger of every row.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.samplers import bucket_cols, run_shards, shard_bounds, \
    shard_devices
from ..core.schemes import MCReport
from ..core.types import HetSpec
from ..device import DEFAULT_DEVICE

from .config import AUTO_SLOTS_PER_JOB, ServingConfig
from .policies import (CoverPolicy, ExchangePolicy, ExchangeUnknownPolicy,
                       GradientCodedPolicy, HedgedPolicy, MDSPolicy,
                       PooledPolicy, StaticPolicy, UniformPolicy,
                       dispatch_policy)

__all__ = ["scan_sweep", "sweep_rows", "LEDGER_FIELDS"]

# physical queue rows for the first Q-tier pass (see sweep_rows), and the
# device types that tier; tests may pin _TIER_Q (sys.maxsize disables
# tiering) to compare against the single full-width dispatch
_TIER_Q = 16
_TIER_DEVICES = ("cpu",)

# pad S, Q, B and K to the reference's buckets, whose shapes set the host
# draws' streams; tests turn it off to compare against the exact shapes
_SHAPE_BUCKETS = True

# the per-row integer outputs of a sweep, in the reference's order
LEDGER_FIELDS = ("shipped", "served", "cancelled", "backlog", "completed",
                 "goodput_w", "su_w", "offered", "rejected")

I32 = torch.int32
F32 = torch.float32


def _pow2(n: int, floor: int = 1) -> int:
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def _f32(x: float) -> float:
    """``x`` rounded to float32, so a Python scalar in a float32 op is the
    value the reference's float32 scalar holds."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# device forms of the dispatch policies
# ---------------------------------------------------------------------------
# Exact-type dispatch (not isinstance): every concrete adapter maps to a
# (kind, static_args) pair; anything else raises.

def _policy_form(policy) -> Tuple[str, Tuple]:
    t = type(policy)
    if t in (ExchangePolicy, ExchangeUnknownPolicy, PooledPolicy,
             StaticPolicy):
        return ("prop", ())
    if t is UniformPolicy:
        return ("uniform", ())
    if t is MDSPolicy:
        return ("mds", (int(policy.L),))
    if t is CoverPolicy:
        return ("cover", ())
    if t is HedgedPolicy:
        return ("hedged", (int(policy.spare),))
    if t is GradientCodedPolicy:
        return ("gc", (int(policy.s), int(policy.K_eff),
                       int(policy.groups)))
    raise NotImplementedError(
        f"the torch serving engine has no device form of the dispatch "
        f"adapter {t.__name__} (scheme {policy.scheme.name!r}); run it on "
        f"the numpy engine (backend='numpy')")


def _isum(x: torch.Tensor, dim) -> torch.Tensor:
    return x.sum(dim, dtype=I32)


def _wsum(w: torch.Tensor) -> torch.Tensor:
    """Row sums of float32 weights, exact in float64 then rounded once:
    the same bits whatever order the device adds in."""
    return w.double().sum(1, keepdim=True).float()


class _Rounder:
    """Row-wise largest-remainder rounding, ``lr_round_rows`` on a device.

    Ranks come from a comparison count (stable-descending position =
    #{larger} + #{equal at lower index}): the same winners as the
    oracle's stable argsort."""

    def __init__(self, n: int, dev: torch.device):
        col = torch.arange(n, device=dev)
        self.earlier = col[None, None, :] < col[None, :, None]

    @staticmethod
    def normalize(w: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
        """``w / w.sum`` per row; all-zero rows take ``fallback``."""
        w = torch.where(_wsum(w) > 0, w, fallback[None, :])
        return w / _wsum(w)

    def split(self, wn: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
        """Split ``totals`` (B,) by normalized weights ``wn`` (B, n)."""
        shares = wn * totals[:, None].to(F32)
        base = torch.floor(shares).to(I32)
        deficit = (totals - _isum(base, 1)).clamp_min(0)
        frac = shares - base
        fi, fj = frac[:, :, None], frac[:, None, :]
        rank = _isum((fj > fi) | ((fj == fi) & self.earlier), 2)
        return base + (rank < deficit[:, None]).to(I32)

    def __call__(self, w, totals, fallback):
        return self.split(self.normalize(w, fallback), totals)


class _Policy:
    """The (place, done) pair of one policy kind on a device.

    ``place(u, believed) -> (shares (B, Kb) int32, ptag (B,) int32 or
    None)``; ``done(R, S0, units, aux) -> (B, Qp) bool``.  ``believed``
    is the (B, Kb) float32 rate belief, zero on padded workers."""

    def __init__(self, kind: str, pargs: Tuple, Kb: int, col_mask_f,
                 redundancy: float, dev: torch.device):
        self.kind, self.pargs, self.Kb = kind, pargs, Kb
        self.col_mask_f = col_mask_f
        self.col_mask_i = col_mask_f.to(I32)
        self.redundancy = _f32(redundancy)
        self.round = _Rounder(Kb, dev)
        self.need_S0 = (kind in ("mds", "cover")
                        or (kind == "hedged" and pargs[0] >= 0))
        self.need_aux = kind == "hedged" and pargs[0] >= 0
        if kind == "hedged" and pargs[0] >= 0:
            spare = pargs[0]
            self.others_f = col_mask_f.clone()
            self.others_f[spare] = 0.0
            self.primary = (torch.arange(Kb, device=dev) != spare)
        if kind == "gc":
            _, _, groups = pargs
            self.group_round = _Rounder(groups, dev)
            self.ones_g = torch.ones(groups, dtype=F32, device=dev)

    def place(self, u, believed):
        kind = self.kind
        if kind == "prop":
            return self.round(believed, u, self.col_mask_f), None
        if kind == "uniform":
            w = self.col_mask_f[None, :].expand(u.shape[0], -1)
            return self.round(w, u, self.col_mask_f), None
        if kind == "mds":
            (L,) = self.pargs
            m = (u + (L - 1)) // L
            return m[:, None] * self.col_mask_i[None, :], None
        if kind == "cover":
            total = torch.ceil(self.redundancy * u.to(F32)).to(I32)
            return self.round(believed, torch.maximum(total, u),
                              self.col_mask_f), None
        if kind == "hedged":
            (spare,) = self.pargs
            if spare < 0:                      # K == 1: degenerate drain
                shares = torch.zeros((u.shape[0], self.Kb), dtype=I32,
                                     device=u.device)
                shares[:, 0] = u
                return shares, None
            w = believed * self.others_f[None, :]
            prim = self.round(w, u, self.others_f)
            loaded = prim > 0
            strag = torch.argmin(torch.where(loaded, w, torch.inf), 1)
            has = loaded.any(1)
            strag_val = torch.gather(prim, 1, strag[:, None])[:, 0]
            shares = prim.clone()
            shares[:, spare] = torch.where(has, strag_val, 0)
            return shares, torch.where(has, strag, -1).to(I32)
        if kind == "gc":
            s_, K_eff, groups = self.pargs
            w = self.ones_g[None, :].expand(u.shape[0], -1)
            blocks = self.group_round(w, u, self.ones_g)
            shares = torch.zeros((u.shape[0], self.Kb), dtype=I32,
                                 device=u.device)
            shares[:, :K_eff] = torch.repeat_interleave(blocks, s_ + 1,
                                                        dim=1)
            return shares, None
        raise AssertionError(f"unknown policy kind {kind!r}")

    def done(self, R, S0, units, aux):
        kind = self.kind
        if kind == "mds":
            (L,) = self.pargs
            return _isum((S0 > 0) & (R == 0), 2) >= L
        if kind == "cover":
            return _isum(S0 * (R == 0), 2) >= units
        if kind == "hedged" and self.pargs[0] >= 0:
            (spare,) = self.pargs
            prim = self.primary[None, None, :] & (S0 > 0)
            undrained = _isum(prim & (R > 0), 2)
            strag_rem = torch.gather(R, 2, aux.clamp_min(0).long()[..., None]
                                     )[..., 0]
            strag_und = (aux >= 0) & (strag_rem > 0)
            ok = (undrained - strag_und.to(I32) == 0) \
                & (~strag_und | (R[..., spare] == 0))
            return torch.where(aux >= 0, ok, _isum(R, 2) == 0)
        if kind == "gc":
            s_, K_eff, groups = self.pargs
            B, Q = R.shape[0], R.shape[1]
            grouped = R[..., :K_eff].reshape(B, Q, groups, s_ + 1)
            return (grouped == 0).any(3).all(2)
        return _isum(R, 2) == 0                # drain


# ---------------------------------------------------------------------------
# the slot loop on the device
# ---------------------------------------------------------------------------

def _run_rows(policy, pol: _Policy, counts_T: np.ndarray, caps: np.ndarray,
              Q_phys: int, S: int, warm: int, exch_every: int,
              scal: Dict[str, Any], n_units: int, seed: int,
              dev: torch.device) -> Dict[str, np.ndarray]:
    """Walk the ``S`` live slots for every row of ``counts_T`` (Sb, B) and
    ``caps`` (Sb, B, Kb) at ``Q_phys`` physical queue rows.  Returns the
    per-row ledger, float accumulators, the warm completion histogram and
    the overflow flags, on the host."""
    Sb, B = counts_T.shape
    Kb = caps.shape[2]
    Hb = Sb + 1
    fixed = scal["units_dist"] == "fixed"
    deadline = scal["admission"] == "deadline"
    uses_est = bool(policy.uses_estimates)
    purge, count_comm = bool(policy.purge), bool(policy.count_comm)
    exchanges = bool(policy.exchanges)
    need_S0, need_aux, need_units = pol.need_S0, pol.need_aux, not fixed
    dt, lam_sum = scal["dt"], scal["lam_sum"]
    q_cap = int(scal["q_cap"])
    room0 = _f32(np.float32(scal["deadline_t"]) * np.float32(lam_sum))

    counts_d = torch.from_numpy(counts_T).to(dev)
    caps_d = torch.from_numpy(caps).to(dev)
    iota_q = torch.arange(Q_phys, dtype=I32, device=dev)
    lam_nom = pol.col_mask_f * torch.from_numpy(scal["lam_pad"]).to(dev)
    nominal = lam_nom[None, :].expand(B, Kb)

    def believed_of(st):
        if uses_est:
            return (st["served_w"] + 1.0) / (st["busy_w"] + 1.0) \
                * pol.col_mask_f[None, :]
        return nominal

    # a placement that is the same every slot is computed once (fixed
    # sizes, nominal beliefs): the same function of the same inputs
    u_fixed = torch.full((B,), n_units, dtype=I32, device=dev)
    if fixed and not uses_est:
        const_place = pol.place(u_fixed, nominal)
    else:
        const_place = None
    if exchanges and not uses_est:
        nominal_wn = pol.round.normalize(nominal, pol.col_mask_f)
    if need_units:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        log1m_p = torch.log1p(torch.tensor(-_f32(scal["geo_p"]),
                                           dtype=F32))
        log1m_p = _f32(float(log1m_p))

    zi = functools.partial(torch.zeros, dtype=I32, device=dev)
    zf = functools.partial(torch.zeros, dtype=F32, device=dev)
    # ``arr`` (the admission slot) is int64: it indexes the histogram
    st = {"R": zi((B, Q_phys, Kb)), "n": zi(B),
          "arr": torch.zeros((B, Q_phys), dtype=torch.int64, device=dev),
          "served_w": zf((B, Kb)), "busy_w": zf((B, Kb)),
          "shipped": zi(B), "served": zi(B), "cancelled": zi(B),
          "hist": zi((B, Hb)), "completed": zi(B), "goodput_w": zi(B),
          "moved_w": zf(B), "qd_sum": zf(B), "su_w": zi(B),
          "offered": zi(B), "rejected": zi(B),
          "over": torch.zeros(B, dtype=torch.bool, device=dev)}
    if need_S0:
        st["S0"] = zi((B, Q_phys, Kb))
    if need_units:
        st["units"] = zi((B, Q_phys))
    if need_aux:
        st["aux"] = torch.full((B, Q_phys), -1, dtype=I32, device=dev)
    A_max = _pow2(int(counts_T.max()), floor=1)
    if const_place is not None:
        const_total = _isum(const_place[0], 1)

    # Rows past the active prefix are never read unmasked: their R is 0
    # (drained or purged jobs, and rows never filled), every other field
    # is rewritten on admission, and completion is masked by ``active``.
    # So compaction moves them without clearing them.
    for s in range(S):
        counts_s, cap_s = counts_d[s], caps_d[s]
        warm_s = s >= warm
        R = st["R"]
        n_active = st["n"]

        # -- 1. rebalance: surplus-only re-deal (exchange class) --------
        if exchanges and s > 0 and s % exch_every == 0:
            b = _isum(R, 1)                                # (B, Kb)
            wn = (pol.round.normalize(believed_of(st), pol.col_mask_f)
                  if uses_est else nominal_wn)
            targets = pol.round.split(wn, _isum(b, 1))
            surplus = (b - targets).clamp_min(0)
            deficit = (targets - b).clamp_min(0)
            behind = b[:, None, :] - torch.cumsum(R, 1, dtype=I32)
            rm = torch.minimum(R, surplus[:, None, :] - behind).clamp_min(0)
            rm_q = _isum(rm, 2)
            end = torch.cumsum(rm_q, 1, dtype=I32)
            start = end - rm_q
            d_hi = torch.cumsum(deficit, 1, dtype=I32)
            d_lo = d_hi - deficit
            add = (torch.minimum(end[:, :, None], d_hi[:, None, :])
                   - torch.maximum(start[:, :, None], d_lo[:, None, :])
                   ).clamp_min(0)
            R = R - rm + add
            if count_comm and warm_s:
                st["moved_w"].add_(_isum(add, (1, 2)))
            st["R"] = R

        # -- 2+3. arrivals, admission, placement -------------------------
        if fixed:
            # every candidate carries the same u, so capacity and
            # deadline admission are both "first a of counts_s" rules
            if warm_s:
                st["offered"].add_(counts_s)
            a = torch.minimum(counts_s, q_cap - n_active)
            if deadline:
                room = room0 - _isum(R, (1, 2))
                a_dl = torch.floor(room / float(max(n_units, 1))).to(I32)
                a = torch.minimum(a, a_dl.clamp_min(0))
            a = a.clamp_min(0)
            n_new = n_active + a
            # the admitted prefix outgrows the physical rows: this row's
            # trajectory leaves the full-width run's, rerun it
            st["over"].logical_or_(n_new > Q_phys)
            if warm_s:
                st["rejected"].add_(counts_s - a)
            if const_place is None:
                shares, ptag = pol.place(u_fixed, believed_of(st))
                total = _isum(shares, 1)
            else:
                (shares, ptag), total = const_place, const_total
            newm = (iota_q[None, :] >= n_active[:, None]) \
                & (iota_q[None, :] < n_new[:, None])
            st["R"] = torch.where(newm[:, :, None], shares[:, None, :], R)
            if need_S0:
                st["S0"] = torch.where(newm[:, :, None], shares[:, None, :],
                                       st["S0"])
            st["arr"] = torch.where(newm, s, st["arr"])
            if need_aux:
                st["aux"] = torch.where(newm, ptag[:, None], st["aux"])
            st["n"] = n_new
            st["shipped"].add_(a * total)
        else:
            for j in range(A_max):
                n_act = st["n"]
                cand = counts_s > j
                if warm_s:
                    st["offered"].add_(cand)
                uu = torch.rand(B, generator=gen, device=dev)
                u = torch.clamp_min(torch.ceil(
                    torch.log1p(-uu) / log1m_p), 1.0).to(I32)
                ok = cand & (n_act < q_cap)
                if deadline:
                    pred = (_isum(st["R"], (1, 2)) + u).to(F32) / lam_sum
                    ok = ok & (pred <= scal["deadline_t"])
                if warm_s:
                    st["rejected"].add_(cand & ~ok)
                shares, ptag = pol.place(u, believed_of(st))
                onehot = (iota_q[None, :] == n_act[:, None]) & ok[:, None]
                st["R"] = torch.where(onehot[:, :, None],
                                      shares[:, None, :], st["R"])
                if need_S0:
                    st["S0"] = torch.where(onehot[:, :, None],
                                           shares[:, None, :], st["S0"])
                st["units"] = torch.where(onehot, u[:, None], st["units"])
                st["arr"] = torch.where(onehot, s, st["arr"])
                if need_aux:
                    st["aux"] = torch.where(onehot, ptag[:, None],
                                            st["aux"])
                st["n"] = n_act + ok
                st["shipped"].add_(torch.where(ok, _isum(shares, 1), 0))
        active = iota_q[None, :] < st["n"][:, None]

        # -- 4. service: per-worker FIFO up to the Poisson budgets -------
        # the queue is stored in FIFO order, so "work ahead of me" is the
        # exclusive prefix sum
        R = st["R"]
        bk_before = _isum(R, 1)
        ahead = torch.cumsum(R, 1, dtype=I32) - R
        srv = torch.minimum(R, (cap_s[:, None, :] - ahead).clamp_min(0))
        R = R - srv
        srv_k = _isum(srv, 1)
        srv_tot = _isum(srv_k, 1)
        st["served"].add_(srv_tot)
        st["served_w"].add_(srv_k)
        st["busy_w"].add_(bk_before > 0, alpha=dt)

        # -- 5. completions ----------------------------------------------
        S0 = st.get("S0")
        units = st["units"] if need_units else n_units
        aux = st.get("aux")
        done = pol.done(R, S0, units, aux) & active
        if purge:
            st["cancelled"].add_(_isum(R * done[:, :, None], (1, 2)))
            R = torch.where(done[:, :, None], 0, R)
        done_i = done.to(I32)
        n_done = _isum(done_i, 1)
        st["completed"].add_(n_done)
        if warm_s:
            if need_units:
                st["goodput_w"].add_(_isum(units * done_i, 1))
            else:
                st["goodput_w"].add_(n_done, alpha=n_units)
            # a job admitted at slot arr <= s: 1 <= s + 1 - arr <= S < Hb
            st["hist"].scatter_add_(1, (s + 1) - st["arr"], done_i)

        # -- 6. compaction: survivors slide left, order kept --------------
        keep = (active & ~done).to(I32)
        src = torch.argsort(keep, dim=1, descending=True, stable=True)
        st["n"] = _isum(keep, 1)
        st["R"] = torch.gather(R, 1, src[:, :, None].expand(-1, -1, Kb))
        if need_S0:
            st["S0"] = torch.gather(S0, 1,
                                    src[:, :, None].expand(-1, -1, Kb))
        if need_units:
            st["units"] = torch.gather(units, 1, src)
        st["arr"] = torch.gather(st["arr"], 1, src)
        if need_aux:
            st["aux"] = torch.gather(aux, 1, src)
        if warm_s:
            st["qd_sum"].add_(_isum(st["R"], (1, 2)))
            st["su_w"].add_(srv_tot)

    st["backlog"] = _isum(st["R"], (1, 2))
    keys = LEDGER_FIELDS + ("moved_w", "qd_sum", "hist", "over")
    return {k: st[k].cpu().numpy() for k in keys}


# ---------------------------------------------------------------------------
# the sweep: host-side assembly around the device loop
# ---------------------------------------------------------------------------

def _setup(het: HetSpec, scheme_name: str, params, cfg: ServingConfig,
           N: int, trials: int, seed: int, grid_index: int,
           rate_schedule, D: int):
    policy = dispatch_policy(scheme_name, dict(params or {}), het, N)
    arrival = cfg.build_arrival()
    if arrival.closed_loop:
        raise ValueError(
            "closed-loop arrivals are engine-driven (the resubmission "
            "ring needs per-slot completions); the torch serving backend "
            "cannot precompute the stream -- use the numpy backend")
    kind, pargs = _policy_form(policy)

    T, K, S = int(trials), het.K, int(cfg.slots)
    if T < 1:
        raise ValueError("trials must be >= 1")
    N = int(N)
    lam = np.asarray(het.lambdas, dtype=np.float64)
    lam_sum = float(het.lambda_sum)
    dt = (float(cfg.slot_dt) if cfg.slot_dt is not None
          else N / lam_sum / AUTO_SLOTS_PER_JOB)
    deadline_t = (None if cfg.deadline_slo is None
                  else float(cfg.deadline_slo) * N / lam_sum)
    loads = [float(x) for x in cfg.loads]
    L = len(loads)

    buckets = _SHAPE_BUCKETS
    Sb = _pow2(S) if buckets else S
    Qb = _pow2(int(cfg.max_queue_jobs)) if buckets \
        else int(cfg.max_queue_jobs)
    Kb = bucket_cols(K) if buckets else K
    B0 = L * T
    Bb = _pow2(B0, floor=8) if buckets else B0
    Bb = -(-Bb // D) * D                    # device-divisible rows

    # arrivals: each load keeps its own default_rng([seed, g, li]) stream
    # (the engine seed discipline -- cells are independent of the sweep)
    counts = np.zeros((Bb, Sb), dtype=np.int32)
    for li, load in enumerate(loads):
        rng = np.random.default_rng(
            [int(seed) & (2 ** 63 - 1), int(grid_index), li])
        jobs_per_slot = load * lam_sum * dt / N
        counts[li * T:(li + 1) * T, :S] = np.asarray(
            arrival.job_counts(T, S, jobs_per_slot, rng), dtype=np.int32)

    # per-slot true-rate rows, pre-stretched over the horizon; padded
    # worker columns carry rate 0 so Poisson budgets stay dead
    lam_pad = np.zeros(Kb, dtype=np.float32)
    lam_pad[:K] = lam
    lam_sched = np.broadcast_to(lam_pad, (Sb, Kb)).copy()
    if rate_schedule is not None:
        sched = np.asarray(rate_schedule, dtype=np.float64)
        if sched.ndim != 2 or sched.shape[1] != K:
            raise ValueError(f"rate_schedule must be (rounds, K={K}); "
                             f"got {sched.shape}")
        rows = np.minimum(np.arange(S) * sched.shape[0] // S,
                          sched.shape[0] - 1)
        lam_sched[:S, :K] = sched[rows].astype(np.float32)
    live = np.arange(Sb) < S

    rng_dev = np.random.default_rng(
        [int(seed) & (2 ** 63 - 1), int(grid_index), 2 ** 31])
    dev_seeds = [int(x) for x in rng_dev.integers(0, 2 ** 32, size=(D,),
                                                  dtype=np.uint32)]

    # per-(slot, row, worker) Poisson service budgets: iid given the rate
    # schedule, so drawn up front on the host (padded slots and workers
    # carry rate 0 -> cap 0)
    rng_cap = np.random.default_rng(
        [int(seed) & (2 ** 63 - 1), int(grid_index), 2 ** 31 + 1])
    caps = rng_cap.poisson(
        lam_sched[:, None, :].astype(np.float64) * dt
        * live[:, None, None], size=(Sb, Bb, Kb)).astype(np.int32)

    redundancy = float(getattr(policy.scheme, "redundancy", 0.0) or 0.0)

    def make_pol(dev: torch.device) -> _Policy:
        col_mask_f = (torch.arange(Kb, device=dev) < K).to(F32)
        return _Policy(kind, pargs, Kb, col_mask_f, redundancy, dev)
    scal = {"dt": _f32(dt),
            "deadline_t": _f32(np.inf if deadline_t is None
                               else deadline_t),
            "lam_sum": _f32(lam_sum), "geo_p": 1.0 / max(N, 1),
            "q_cap": int(cfg.max_queue_jobs), "lam_pad": lam_pad,
            "admission": str(cfg.admission),
            "units_dist": str(cfg.job_units_dist)}
    meta = dict(policy=policy, make_pol=make_pol, counts=counts, caps=caps,
                dev_seeds=dev_seeds, scal=scal, T=T, S=S, Sb=Sb, Qb=Qb,
                B0=B0, buckets=buckets, dt=dt, deadline_t=deadline_t,
                loads=loads, lam_sum=lam_sum,
                warm=int(float(cfg.warmup_frac) * S),
                every=int(cfg.exchange_every), N=N)
    return meta


def sweep_rows(het: HetSpec, scheme_name: str,
               params: Optional[Dict[str, Any]], cfg: ServingConfig,
               N: int, trials: int, seed: int, grid_index: int,
               rate_schedule: Optional[np.ndarray] = None,
               device=DEFAULT_DEVICE) -> Tuple[Dict[str, np.ndarray],
                                               Dict[str, Any]]:
    """The per-row outputs of one cell's sweep on ``device``, before they
    fold into reports: ``(out, meta)``, ``out`` holding the integer
    ledger (``LEDGER_FIELDS``), ``moved_w`` / ``qd_sum`` (float32) and
    the warm completion histogram ``hist`` for the ``len(loads) *
    trials`` real rows (loads major), ``meta`` the sweep's constants and
    ``passes`` (1, or 2 when the tier splice reran rows) and
    ``rows_rerun``."""
    mesh = shard_devices(device)
    D = len(mesh)
    m = _setup(het, scheme_name, params, cfg, N, trials, seed, grid_index,
               rate_schedule, D)
    counts_T = np.ascontiguousarray(m["counts"].T)
    caps, B0 = m["caps"], m["B0"]

    def run_block(bdev, counts_b, caps_b, dev_seed, n_real):
        """The sweep of one block of rows (its first ``n_real`` real) on
        ``bdev``: ``(out, passes, rows_rerun)``."""
        pol = m["make_pol"](bdev)

        def dispatch(Q_phys, counts_x, caps_x):
            with torch.inference_mode():
                return _run_rows(m["policy"], pol, counts_x, caps_x,
                                 Q_phys, m["S"], m["warm"], m["every"],
                                 m["scal"], m["N"], dev_seed, bdev)

        # Q-tiering: run everything at _TIER_Q rows, then rerun exactly
        # the rows whose ``over`` flag shows the admitted prefix outgrew
        # them.  Fixed-units rows draw nothing on the device and are
        # independent, so the splice is bit-identical to one full-width
        # run.  Geometric sizes draw per-(slot, row) uniforms, so row
        # subsets would shift their streams -- no tiering.
        use_tier = (m["scal"]["units_dist"] == "fixed" and m["buckets"]
                    and m["Qb"] > _TIER_Q and bdev.type in _TIER_DEVICES)
        if not use_tier:
            return dispatch(m["Qb"], counts_b, caps_b), 1, 0
        out = dispatch(_TIER_Q, counts_b, caps_b)
        rows = np.nonzero(out["over"][:n_real])[0]
        if rows.size == 0:
            return out, 1, 0
        rerun = int(rows.size)
        B2b = _pow2(rerun, floor=8)
        c2 = np.zeros((m["Sb"], B2b), np.int32)
        c2[:, :rerun] = counts_b[:, rows]
        k2 = np.zeros((m["Sb"], B2b, caps_b.shape[2]), np.int32)
        k2[:, :rerun] = caps_b[:, rows, :]
        out2 = dispatch(m["Qb"], c2, k2)
        for key in out:
            out[key][rows] = out2[key][:rerun]
        return out, 2, rerun

    blocks = run_shards(run_block, mesh, [
        (np.ascontiguousarray(counts_T[:, lo:hi]),
         np.ascontiguousarray(caps[:, lo:hi]), s,
         min(max(B0 - lo, 0), hi - lo))
        for (lo, hi), s in zip(shard_bounds(counts_T.shape[1], D),
                               m["dev_seeds"])])
    out = {k: np.concatenate([b[0][k] for b in blocks])
           for k in blocks[0][0]}
    passes = max(b[1] for b in blocks)
    rerun = sum(b[2] for b in blocks)
    out = {k: v[:B0] for k, v in out.items() if k != "over"}

    # exact conservation identity on the final ledger
    ok = out["shipped"] == (out["served"] + out["cancelled"]
                            + out["backlog"])
    if not ok.all():
        bad = int(np.nonzero(~ok)[0][0])
        raise AssertionError(
            f"work conservation violated in the torch backend "
            f"({scheme_name}, row {bad}): shipped {int(out['shipped'][bad])}"
            f" != served {int(out['served'][bad])} + cancelled "
            f"{int(out['cancelled'][bad])} + backlog "
            f"{int(out['backlog'][bad])}")
    meta = {k: m[k] for k in ("T", "S", "Sb", "dt", "deadline_t", "loads",
                              "lam_sum", "warm")}
    meta.update(scheme=m["policy"].scheme.name, passes=passes,
                rows_rerun=rerun)
    return out, meta


def scan_sweep(het: HetSpec, scheme_name: str,
               params: Optional[Dict[str, Any]], cfg: ServingConfig,
               N: int, trials: int, seed: int, grid_index: int,
               rate_schedule: Optional[np.ndarray] = None,
               device=DEFAULT_DEVICE) -> List[MCReport]:
    """Every load of one (het, scheme, schedule) cell in ONE loop on
    ``device``; returns one ``MCReport`` per load in ``cfg.loads`` order,
    extras keyed identically to the numpy oracle (plus
    ``serving_backend``)."""
    out, m = sweep_rows(het, scheme_name, params, cfg, N, trials, seed,
                        grid_index, rate_schedule, device=device)
    T, S, dt, warm = m["T"], m["S"], m["dt"], m["warm"]
    lam_sum, deadline_t = m["lam_sum"], m["deadline_t"]
    window_t = (S - warm) * dt
    horizon_t = S * dt
    hist = out["hist"]
    bin_vals = np.arange(hist.shape[1], dtype=np.float64) * dt
    reports: List[MCReport] = []
    for li, load in enumerate(m["loads"]):
        r = slice(li * T, (li + 1) * T)
        h = hist[r]                              # (T, Hb) warm completions
        cw = h.sum(axis=1)
        sum_soj = (h * bin_vals[None, :]).sum(axis=1)
        per_trial = np.where(cw > 0, sum_soj / np.maximum(cw, 1),
                             horizon_t)
        pooled = h.sum(axis=0)
        if pooled.sum() > 0:
            soj_pool = np.repeat(bin_vals, pooled)
            p50, p95, p99 = (float(x) for x in
                             np.percentile(soj_pool, [50.0, 95.0, 99.0]))
            latency_censored = False
        else:
            p50 = p95 = p99 = horizon_t
            latency_censored = True
        censored = int((cw == 0).sum())
        extra: Dict[str, Any] = {
            "serving": 1.0,
            "offered_load": float(load),
            "slot_dt": float(dt),
            "p50": p50, "p95": p95, "p99": p99,
            "throughput_jobs": float(cw.mean() / window_t),
            "goodput_units": float(out["goodput_w"][r].mean() / window_t),
            "occupancy": float(out["su_w"][r].mean()
                               / (lam_sum * window_t)),
            "queue_depth": float(out["qd_sum"][r].mean()
                                 / max(S - warm, 1)),
            "reject_rate": float(out["rejected"][r].sum()
                                 / max(out["offered"][r].sum(), 1)),
            "completed_jobs": float(out["completed"][r].mean()),
            "units_admitted": float(out["shipped"][r].mean()),
            "units_served": float(out["served"][r].mean()),
            "units_cancelled": float(out["cancelled"][r].mean()),
            "units_backlog": float(out["backlog"][r].mean()),
        }
        if deadline_t is not None:
            extra["deadline_s"] = float(deadline_t)
            miss_bins = bin_vals > deadline_t + 1e-12
            extra["slo_miss_rate"] = float(
                (pooled * miss_bins).sum() / max(cw.sum(), 1))
        extra["latency_censored"] = 1.0 if latency_censored else 0.0
        if censored:
            extra["censored"] = float(censored)
            extra["censored_frac"] = float(censored / T)
        extra["serving_backend"] = "torch"
        per_cw = cw.astype(np.float64)
        moved = out["moved_w"][r]
        reports.append(MCReport(
            scheme=m["scheme"], trials=T,
            t_comp=float(per_trial.mean()),
            t_comp_std=float(per_trial.std()),
            iterations=float(per_cw.mean()),
            iterations_std=float(per_cw.std()),
            n_comm=float(moved.mean()), n_comm_std=float(moved.std()),
            extra=extra))
    return reports
