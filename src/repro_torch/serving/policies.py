"""Dispatch policies: every registered scheme, recast for arrivals.  The
port of ``repro.serving.policies``.

The batch schemes answer "how do I split ONE batch of N units and when
is it done?"; under continuous arrivals the same two decisions recur per
job: *placement* (which workers get how many of this job's units) and
*completion* (when do the served shards constitute a finished job).  A
``DispatchPolicy`` is exactly that pair, derived from a scheme instance:

    placement               completion              flags
    ------------------------------------------------------------------
    oracle       proportional (re-dealt)  drain     exchanges, free comm
    work_exchange proportional (re-dealt) drain     exchanges
    work_exchange_unknown  by online estimates      exchanges, estimates
    fixed / trace_replay   proportional, static     drain
    uniform      equal, static            drain
    mds          ceil(u/L) coded shards   L shards done     purge
    het_mds      HCMM loads (r * u total) loads cover u     purge
    hedged       K-1 primaries + spare    primaries + min(replica) purge
    gradient_coded  FR groups             every group has a finisher purge
    (anything else) scheme.initial_sizes  drain / served >= u [#]_

.. [#] the generic fallback keys off ``Scheme.redundant`` -- so a future
   ``@register_scheme`` inherits the serving engine (and its test
   battery) with no adapter at all.

Policies are trials-batched like the engine: ``place`` maps the units of
M admitted jobs to an ``(M, K)`` integer share matrix; ``done_mask``
maps the engine's ``(T, Q, K)`` remaining/shipped state to per-job
completion.  Schemes that *exchange* set ``exchanges`` and the engine
re-deals leftover units across workers every ``exchange_every`` slots
(counted into ``n_comm`` unless the policy is the free-coordination
oracle); coded schemes set ``purge`` and the engine cancels leftover
shards on completion.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np

from ..core.schemes import Scheme, get_scheme

__all__ = ["DispatchPolicy", "dispatch_policy", "lr_round_rows",
           "POLICY_ADAPTERS", "register_policy"]


def lr_round_rows(weights: np.ndarray, totals: np.ndarray) -> np.ndarray:
    """Row-wise largest-remainder rounding: split ``totals[m]`` units
    proportionally to ``weights[m]`` into non-negative integers that sum
    exactly to ``totals[m]`` (the batched form of
    ``repro_torch.core.assignment.largest_remainder_round``).  All-zero weight
    rows fall back to a uniform split."""
    w = np.asarray(weights, dtype=np.float64)
    totals = np.asarray(totals, dtype=np.int64)
    s = w.sum(axis=1, keepdims=True)
    w = np.where(s > 0, w, 1.0)
    shares = w / w.sum(axis=1, keepdims=True) * totals[:, None]
    base = np.floor(shares).astype(np.int64)
    deficit = totals - base.sum(axis=1)
    order = np.argsort(-(shares - base), axis=1, kind="stable")
    bump = np.zeros_like(base)
    take = (np.arange(w.shape[1])[None, :] < deficit[:, None])
    np.put_along_axis(bump, order, take.astype(np.int64), axis=1)
    return base + bump


class DispatchPolicy:
    """Scheme -> (placement, completion) adapter; see module docstring.

    ``place(units, believed)`` returns the ``(M, K)`` integer shares for
    M admitted jobs (``believed`` is the ``(M, K)`` rate belief: nominal
    rates, or the per-trial online estimates for estimate-driven
    policies) -- optionally ``(shares, aux)`` with a per-job int64 tag
    the engine stores and hands back to ``done_mask``.
    ``done_mask(R, S0, units, active, aux)`` marks finished jobs from
    the remaining/shipped unit state.
    """

    exchanges = False        # engine re-deals leftovers periodically
    count_comm = True        # re-dealt units count into n_comm
    purge = False            # cancel leftover shards on completion
    uses_estimates = False   # placement/re-deal follow online estimates

    def __init__(self, scheme: Scheme, het, N: int):
        self.scheme = scheme
        self.het = het
        self.K = het.K
        self.N = int(N)

    def place(self, units: np.ndarray, believed: np.ndarray):
        raise NotImplementedError

    def done_mask(self, R, S0, units, active, aux) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def _drain(R, active):
        return active & (R.sum(axis=2) == 0)


POLICY_ADAPTERS: Dict[str, Type[DispatchPolicy]] = {}


def register_policy(*scheme_names):
    """Class decorator: adapt the named schemes with this policy."""
    def deco(cls: Type[DispatchPolicy]) -> Type[DispatchPolicy]:
        for name in scheme_names:
            if name in POLICY_ADAPTERS:
                raise ValueError(f"policy for scheme {name!r} already "
                                 f"registered")
            POLICY_ADAPTERS[name] = cls
        return cls
    return deco


def dispatch_policy(scheme_name: str, params: dict, het,
                    N: int) -> DispatchPolicy:
    """Adapt a registered scheme (by name or alias) into its dispatch
    policy; schemes without a dedicated adapter get the generic one."""
    scheme = get_scheme(scheme_name, **(params or {}))
    cls = POLICY_ADAPTERS.get(scheme.name, GenericPolicy)
    return cls(scheme, het, N)


# ---------------------------------------------------------------------------
# exchange-class policies: proportional placement + periodic re-deal
# ---------------------------------------------------------------------------

@register_policy("work_exchange")
class ExchangePolicy(DispatchPolicy):
    """Work-exchange dispatch, rates known: place proportionally to the
    nominal rates; the engine re-deals ALL leftover units across workers
    every ``exchange_every`` slots (moved units -> ``n_comm``)."""

    exchanges = True

    def place(self, units, believed):
        lam = np.broadcast_to(self.het.lambdas, (units.size, self.K))
        return lr_round_rows(lam, units)

    def done_mask(self, R, S0, units, active, aux):
        return self._drain(R, active)


@register_policy("work_exchange_unknown")
class ExchangeUnknownPolicy(ExchangePolicy):
    """Work-exchange dispatch, rates unknown: placement and re-deals
    follow the engine's online served/busy-time estimates (prior 1.0),
    the serving-plane analogue of paper eq. 23."""

    uses_estimates = True

    def place(self, units, believed):
        return lr_round_rows(believed, units)


@register_policy("oracle")
class PooledPolicy(ExchangePolicy):
    """Theorem-1 style lower bound under arrivals: perfectly rebalanced
    every slot with FREE coordination -- the re-deal happens but moved
    units never count into ``n_comm``."""

    count_comm = False


# ---------------------------------------------------------------------------
# static uncoded policies
# ---------------------------------------------------------------------------

@register_policy("fixed", "trace_replay")
class StaticPolicy(DispatchPolicy):
    """Heterogeneity-aware static split: proportional once, never moved."""

    def place(self, units, believed):
        lam = np.broadcast_to(self.het.lambdas, (units.size, self.K))
        return lr_round_rows(lam, units)

    def done_mask(self, R, S0, units, active, aux):
        return self._drain(R, active)


@register_policy("uniform")
class UniformPolicy(StaticPolicy):
    """Heterogeneity-blind static split: u/K each."""

    def place(self, units, believed):
        return lr_round_rows(np.ones((units.size, self.K)), units)


# ---------------------------------------------------------------------------
# coded policies: redundancy instead of exchange
# ---------------------------------------------------------------------------

@register_policy("mds")
class MDSPolicy(DispatchPolicy):
    """(K, L) MDS dispatch: every worker gets a ceil(u/L) coded shard;
    the job decodes when any L shards drain, leftovers are cancelled.
    ``L=None`` resolves once per (het, mean job size) by the scheme's
    own MC sweep, pinned to the exact numpy sampler."""

    purge = True

    def __init__(self, scheme, het, N):
        super().__init__(scheme, het, N)
        if scheme.L is not None:
            self.L = int(scheme.L)
            if not 1 <= self.L <= het.K:
                raise ValueError(f"L must be in [1, {het.K}]; got {self.L}")
        else:
            from ..core.schemes import mds_sweep_batched
            self.L = int(mds_sweep_batched(het, max(self.N, 1),
                                           scheme.opt_trials,
                                           np.random.default_rng(0),
                                           backend="numpy",
                                           device="cpu")[0])

    def place(self, units, believed):
        m = -(-units // self.L)                      # ceil(u / L)
        return np.broadcast_to(m[:, None], (units.size, self.K)).copy()

    def done_mask(self, R, S0, units, active, aux):
        decoded = ((S0 > 0) & (R == 0)).sum(axis=2) >= self.L
        return active & decoded


@register_policy("het_mds")
class CoverPolicy(DispatchPolicy):
    """HCMM-style heterogeneous coded dispatch: worker k gets a coded
    load proportional to its rate with aggregate redundancy r (total
    ceil(r u)); the job completes when the DRAINED workers' loads cover
    u.  Leftovers are cancelled."""

    purge = True

    def place(self, units, believed):
        lam = np.broadcast_to(self.het.lambdas, (units.size, self.K))
        total = np.ceil(self.scheme.redundancy
                        * units.astype(np.float64)).astype(np.int64)
        return lr_round_rows(lam, np.maximum(total, units))

    def done_mask(self, R, S0, units, active, aux):
        covered = (S0 * (R == 0)).sum(axis=2) >= units
        return active & covered


@register_policy("hedged")
class HedgedPolicy(DispatchPolicy):
    """Replication-on-slowest: the fastest worker is a hot spare
    mirroring the predicted straggler's shard; the job completes when
    every primary shard drains, the straggler's counting as done when
    either replica drains.  ``aux`` carries the per-job straggler id
    (-1 = no hedge: degenerate drain)."""

    purge = True

    def __init__(self, scheme, het, N):
        super().__init__(scheme, het, N)
        self.spare = (int(np.argmax(het.lambdas)) if het.K > 1 else -1)

    def place(self, units, believed):
        M = units.size
        shares = np.zeros((M, self.K), dtype=np.int64)
        if self.spare < 0:
            shares[:, 0] = units
            return shares, np.full(M, -1, dtype=np.int64)
        others = np.delete(np.arange(self.K), self.spare)
        lam_o = self.het.lambdas[others]
        prim = lr_round_rows(np.broadcast_to(lam_o, (M, self.K - 1)),
                             units)
        shares[:, others] = prim
        # straggler = lowest-rate worker that actually got load
        loaded = prim > 0
        key = np.where(loaded, lam_o[None, :], np.inf)
        strag_o = np.argmin(key, axis=1)
        has = loaded.any(axis=1)
        strag = np.where(has, others[strag_o], -1).astype(np.int64)
        rows = np.nonzero(has)[0]
        shares[rows, self.spare] = prim[rows, strag_o[rows]]
        return shares, strag

    def done_mask(self, R, S0, units, active, aux):
        if self.spare < 0:
            return self._drain(R, active)
        col = np.arange(self.K)
        prim = (col != self.spare)[None, None, :] & (S0 > 0)
        undrained = (prim & (R > 0)).sum(axis=2)
        idx = np.maximum(aux, 0)[..., None]
        strag_rem = np.take_along_axis(R, idx, axis=2)[..., 0]
        strag_undrained = (aux >= 0) & (strag_rem > 0)
        spare_drained = R[..., self.spare] == 0
        hedged_ok = ~strag_undrained | spare_drained
        done = (undrained - strag_undrained.astype(np.int64) == 0) \
            & hedged_ok
        return active & np.where(aux >= 0, done,
                                 R.sum(axis=2) == 0)


@register_policy("gradient_coded")
class GradientCodedPolicy(DispatchPolicy):
    """Fractional-repetition dispatch: workers form groups of s+1, the
    job's units split into one block per group, every group member
    serves a replica of its block; the job completes when every
    (non-empty) block has a drained replica.  Workers beyond the largest
    multiple of s+1 idle, exactly as in the batch scheme."""

    purge = True

    def __init__(self, scheme, het, N):
        super().__init__(scheme, het, N)
        self.s = int(scheme.s)
        self.K_eff = het.K - het.K % (self.s + 1)
        if self.K_eff < self.s + 1:
            raise ValueError(f"need >= {self.s + 1} workers for "
                             f"s={self.s}")
        self.groups = self.K_eff // (self.s + 1)

    def place(self, units, believed):
        M = units.size
        blocks = lr_round_rows(np.ones((M, self.groups)), units)
        shares = np.zeros((M, self.K), dtype=np.int64)
        shares[:, :self.K_eff] = np.repeat(blocks, self.s + 1, axis=1)
        return shares

    def done_mask(self, R, S0, units, active, aux):
        T, Q, _ = R.shape
        grouped = R[..., :self.K_eff].reshape(T, Q, self.groups,
                                              self.s + 1)
        covered = (grouped == 0).any(axis=3).all(axis=2)
        return active & covered


# ---------------------------------------------------------------------------
# generic fallback: any future scheme inherits the serving engine
# ---------------------------------------------------------------------------

class GenericPolicy(DispatchPolicy):
    """Adapter of last resort, from the base ``Scheme`` surface alone:
    placement is ``scheme.initial_sizes(het, u)`` per job; completion is
    drain for conservative schemes and served >= u (leftovers cancelled)
    for ``redundant`` ones."""

    def __init__(self, scheme, het, N):
        super().__init__(scheme, het, N)
        self.purge = bool(scheme.redundant)

    def place(self, units, believed):
        shares = np.zeros((units.size, self.K), dtype=np.int64)
        for m, u in enumerate(units):
            shares[m] = np.asarray(
                self.scheme.initial_sizes(self.het, int(u)), dtype=np.int64)
        return shares

    def done_mask(self, R, S0, units, active, aux):
        if self.scheme.redundant:
            return active & ((S0 - R).sum(axis=2) >= units)
        return self._drain(R, active)
