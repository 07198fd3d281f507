"""Closed-form M/M/K queueing results (Erlang-C) for engine validation.
The port of ``repro.serving.queueing``.

The serving engine is a slotted-time simulator; these are the textbook
steady-state formulas it is sanity-checked against in the one regime
where an exact answer exists: homogeneous workers, 1-unit jobs, Poisson
arrivals, and a work-conserving pooled dispatch policy (work exchange
with per-slot rebalancing).  In that regime the number-in-system process
is exactly M/M/K up to the O(slot_dt) discretization, so the simulated
mean sojourn must match ``mmk_sojourn`` within MC + slotting tolerance
(``tests/test_torch_serving.py``).

Not to be confused with ``repro_torch.core.erlang`` -- that module computes
order statistics of Erlang *completion times* (paper Section 3); this
one is queueing theory for the arrival plane.
"""
from __future__ import annotations

import math

__all__ = ["erlang_b", "erlang_c", "mmk_wait", "mmk_sojourn",
           "mm1_sojourn"]


def erlang_b(K: int, a: float) -> float:
    """Erlang-B blocking probability for ``K`` servers at offered load
    ``a = lambda / mu`` (in Erlangs), by the standard stable recursion
    ``B(0) = 1,  B(j) = a B(j-1) / (j + a B(j-1))``."""
    if K < 1:
        raise ValueError("erlang_b needs K >= 1")
    if a < 0:
        raise ValueError("offered load must be >= 0")
    b = 1.0
    for j in range(1, K + 1):
        b = a * b / (j + a * b)
    return b


def erlang_c(K: int, a: float) -> float:
    """Erlang-C probability that an arriving job must wait (M/M/K with
    ``a = lambda / mu < K``): ``C = K B / (K - a (1 - B))``."""
    if not a < K:
        raise ValueError(f"M/M/K needs offered load a < K; got a={a}, K={K}")
    b = erlang_b(K, a)
    return K * b / (K - a * (1.0 - b))


def mmk_wait(lam: float, mu: float, K: int) -> float:
    """Mean queueing delay (excluding service) of M/M/K:
    ``W_q = C(K, a) / (K mu - lambda)``."""
    if lam >= K * mu:
        return math.inf
    return erlang_c(K, lam / mu) / (K * mu - lam)


def mmk_sojourn(lam: float, mu: float, K: int) -> float:
    """Mean sojourn (wait + service) of M/M/K: ``W = W_q + 1/mu``."""
    return mmk_wait(lam, mu, K) + 1.0 / mu


def mm1_sojourn(lam: float, mu: float) -> float:
    """Mean sojourn of M/M/1: ``1 / (mu - lambda)`` (equals
    ``mmk_sojourn(lam, mu, 1)``; kept for readable tests)."""
    if lam >= mu:
        return math.inf
    return 1.0 / (mu - lam)
