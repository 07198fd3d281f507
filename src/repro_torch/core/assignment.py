"""Work assignment rules (paper eqs. 14, 16, 18, 22, 24).

The port's own copy of ``repro.core.assignment``: the scalar rules and
their trial-batched forms, line for line the reference's, so that the
exact numpy backend assigns bit for bit as the reference's does.  All
assignments are integral: the paper works with real-valued point counts;
we round with the largest-remainder method so that the assignment exactly
sums to the intended total (work conservation at the unit level).
"""
from __future__ import annotations

import numpy as np


def largest_remainder_round(shares: np.ndarray, total: int) -> np.ndarray:
    """Round non-negative real shares (summing ~ total) to ints summing to total.

    The trial-batched variant (`largest_remainder_round_batch`) applies the
    same sort routine per row, so both paths break remainder ties
    identically and produce bit-identical assignments from the same inputs.
    """
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


def largest_remainder_round_batch(shares: np.ndarray,
                                  totals: np.ndarray) -> np.ndarray:
    """Row-wise ``largest_remainder_round``: shares (T, K), totals (T,).

    Each row i is rounded exactly as ``largest_remainder_round(shares[i],
    totals[i])`` would round it (same ones-fallback for degenerate rows, same
    stable tie-break), but in O(T K log K) vectorized work with no Python
    loop over trials.
    """
    shares = np.asarray(shares, dtype=np.float64)
    totals = np.asarray(totals, dtype=np.int64)
    T, K = shares.shape
    row_sum = shares.sum(axis=1)
    if (row_sum <= 0).any():
        shares = np.where((row_sum <= 0)[:, None], 1.0, shares)
        row_sum = shares.sum(axis=1)
    scaled = shares * (totals / row_sum)[:, None]
    floor = scaled.astype(np.int64)        # scaled >= 0, so trunc == floor
    short = totals - floor.sum(axis=1)
    order = np.argsort(floor - scaled, axis=1)
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(K), (T, K)), 1)
    floor += rank < short[:, None]
    if (totals == 0).any():
        floor = np.where((totals == 0)[:, None], 0, floor)
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
    # Iterate the water-filling: at most K rounds (each round caps >=1 worker
    # or distributes everything).
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


def capped_proportional_assignment_batch(lambdas: np.ndarray,
                                         n_rem: np.ndarray,
                                         cap: int) -> np.ndarray:
    """Row-wise ``capped_proportional_assignment``: lambdas (T, K), n_rem (T,).

    Replays the scalar water-filling rounds for every trial at once; trials
    exit the round loop independently (same break conditions as the scalar
    code), so row i equals ``capped_proportional_assignment(lambdas[i],
    n_rem[i], cap)`` exactly.
    """
    lam = np.asarray(lambdas, dtype=np.float64)
    T, K = lam.shape
    assign = np.zeros((T, K), dtype=np.int64)
    remaining = np.asarray(n_rem, dtype=np.int64).copy()
    active = np.ones((T, K), dtype=bool)
    looping = np.ones(T, dtype=bool)
    for _ in range(K):
        looping &= (remaining > 0) & active.any(axis=1)
        if not looping.any():
            break
        share = largest_remainder_round_batch(np.where(active, lam, 0.0),
                                              np.where(looping, remaining, 0))
        room = cap - assign
        take = np.minimum(share, np.maximum(room, 0))
        take = np.where(looping[:, None], take, 0)
        assign += take
        remaining -= take.sum(axis=1)
        newly_capped = assign >= cap
        looping &= (newly_capped & active).any(axis=1)
        active &= ~newly_capped
    return assign


def uniform_assignment(K: int, n: int) -> np.ndarray:
    """Initial assignment of the unknown-heterogeneity variant: N/K each."""
    return largest_remainder_round(np.ones(K), n)


def water_filling_view(lambdas: np.ndarray, n: int) -> np.ndarray:
    """The oracle allocation (Cor. 2) seen as water-filling: every worker's
    *finish time* is equalized at N/lambda_sum; faster channels (higher
    lambda) absorb more load. Returns per-worker expected finish times."""
    lam = np.asarray(lambdas, np.float64)
    alloc = lam * (n / lam.sum())
    return alloc / lam  # == n/lam.sum() for every worker: the "water level"
