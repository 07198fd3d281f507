"""Exact order statistics of non-identically distributed Erlang variables:
the port's copy of ``repro.core.erlang``.

Implements the Abdelkader (2004) recursion the paper uses in Section 3
(eqs. 4-5) to evaluate the mean completion time of the (K, L) MDS-coded
scheme:  E[T^MDS(L)] = mu_(L, m) at m = N/L, where mu_(l, m) is the mean
of the l-th order statistic of K independent Erlang(m, lambda_k) variables.

    mu_(l,m) = mu_(l-1,m) + sum_{j=1}^{l} (-1)^{j-1} C(K-l+j, j-1) P^m_{K-l+j}

    P^m_s    = sum over subsets S of size s of
               (1/lam_S) * sum_{0<=n_i<m} multinomial(sum n; n) prod (lam_i/lam_S)^{n_i}

The inner truncated-multinomial sum is evaluated through generating
polynomials: it equals  sum_t t! [x^t] prod_{i in S} E_m(p_i x)  with
E_m(y) = sum_{n<m} y^n/n!.  Exact in float64 for the small (K, m) regime;
paper-scale (m ~ 2e4) uses the Monte-Carlo simulator instead.
"""
from __future__ import annotations

import itertools
import math
from functools import lru_cache

import numpy as np

from .types import HetSpec


def _truncated_exp_poly(p: float, m: int) -> np.ndarray:
    """Coefficients of E_m(p x) = sum_{n=0}^{m-1} p^n x^n / n!  (length m)."""
    coeffs = np.empty(m, dtype=np.float64)
    c = 1.0
    for n in range(m):
        coeffs[n] = c
        c *= p / (n + 1)
    return coeffs


def _subset_term(lams: np.ndarray, m: int) -> float:
    """Inner sum of eq. (5) for one subset with rates ``lams``."""
    lam_s = float(lams.sum())
    p = lams / lam_s
    # polynomial product of truncated exponentials
    poly = np.array([1.0])
    for pi in p:
        poly = np.convolve(poly, _truncated_exp_poly(float(pi), m))
    # sum_t t! * coeff[t]
    total = 0.0
    fact = 1.0
    for t, c in enumerate(poly):
        if t > 0:
            fact *= t
        total += fact * float(c)
    return total / lam_s


def p_j_m(het: HetSpec, j: int, m: int) -> float:
    """P^m_j of eq. (5): sum over all subsets of size j."""
    lam = het.lambdas
    K = het.K
    return float(sum(_subset_term(lam[list(S)], m)
                     for S in itertools.combinations(range(K), j)))


def erlang_order_stat_means(het: HetSpec, m: int, L: int | None = None
                            ) -> np.ndarray:
    """mu_(l, m) for l = 1..L via the recursion (4). Returns array length L."""
    K = het.K
    L = K if L is None else L
    if not 1 <= L <= K:
        raise ValueError("L must be in [1, K]")
    # precompute P^m_s for s = 1..K (only sizes >= K-L+1 are needed)
    needed = sorted({K - ell + j for ell in range(1, L + 1)
                     for j in range(1, ell + 1)})
    P = {s: p_j_m(het, s, m) for s in needed}
    mus = np.zeros(L, dtype=np.float64)
    prev = 0.0
    for ell in range(1, L + 1):
        delta = 0.0
        for j in range(1, ell + 1):
            s = K - ell + j
            delta += (-1.0) ** (j - 1) * math.comb(s, j - 1) * P[s]
        prev = prev + delta
        mus[ell - 1] = prev
    return mus


def erlang_order_stat_mean(het: HetSpec, m: int, ell: int) -> float:
    """Mean of the ell-th order statistic of Erlang(m, lambda_k), k=1..K."""
    return float(erlang_order_stat_means(het, m, ell)[-1])


def erlang_order_stat_mean_mc(het: HetSpec, m: int, ell: int, trials: int,
                              rng: np.random.Generator) -> float:
    """Monte-Carlo cross-check for the recursion."""
    samples = rng.gamma(shape=m, scale=1.0 / het.lambdas,
                        size=(trials, het.K))
    ordered = np.sort(samples, axis=1)
    return float(ordered[:, ell - 1].mean())
