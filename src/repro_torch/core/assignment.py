"""Work assignment rules (paper eqs. 14, 16, 18, 22, 24), scalar form.

The port's own copy of the scalar rules of ``repro.core.assignment``
that ``Scheme.initial_sizes`` uses.  All assignments are integral: the
paper works with real-valued point counts; we round with the
largest-remainder method so that the assignment exactly sums to the
intended total (work conservation at the unit level).
"""
from __future__ import annotations

import numpy as np


def largest_remainder_round(shares: np.ndarray, total: int) -> np.ndarray:
    """Round non-negative real shares (summing ~ total) to ints summing to total."""
    shares = np.asarray(shares, dtype=np.float64)
    if total == 0:
        return np.zeros_like(shares, dtype=np.int64)
    if shares.sum() <= 0:
        shares = np.ones_like(shares)
    scaled = shares * (total / shares.sum())
    floor = np.floor(scaled).astype(np.int64)
    short = total - int(floor.sum())
    if short > 0:
        order = np.argsort(-(scaled - floor))  # biggest remainders first
        floor[order[:short]] += 1
    return floor


def proportional_assignment(lambdas: np.ndarray, n_rem: int) -> np.ndarray:
    """Eq. (16)/(18): N_assign^(k) = lambda_k * N_rem / lambda_sum, integral."""
    return largest_remainder_round(np.asarray(lambdas, np.float64), n_rem)


def capped_proportional_assignment(lambdas: np.ndarray, n_rem: int,
                                   cap: int) -> np.ndarray:
    """Eq. (22)/(24): min(cap, lambda_k * N_rem / lambda_sum).

    Per Algorithm 3, the capped assignment may not exhaust ``n_rem``; the
    shortfall is *carried over* to the next iteration by the caller.
    Water-filling refinement: units freed by the cap are re-offered to
    uncapped workers proportionally (still respecting the cap), which
    strictly reduces the carried remainder without violating storage.
    """
    lam = np.asarray(lambdas, dtype=np.float64)
    K = lam.size
    assign = np.zeros(K, dtype=np.int64)
    remaining = int(n_rem)
    active = np.ones(K, dtype=bool)
    # at most K rounds: each round caps >= 1 worker or distributes everything
    for _ in range(K):
        if remaining <= 0 or not active.any():
            break
        share = largest_remainder_round(
            np.where(active, lam, 0.0), remaining)
        room = cap - assign
        take = np.minimum(share, np.maximum(room, 0))
        assign += take
        remaining -= int(take.sum())
        newly_capped = assign >= cap
        if not (newly_capped & active).any():
            break
        active &= ~newly_capped
    return assign


def uniform_assignment(K: int, n: int) -> np.ndarray:
    """Initial assignment of the unknown-heterogeneity variant: N/K each."""
    return largest_remainder_round(np.ones(K), n)
