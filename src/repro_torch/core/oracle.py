"""Oracle lower bound via the work-conservation principle (paper Section
4): the port's copy of ``repro.core.oracle``.

Theorem 1:  E[T_comp^oracle] = N / lambda_sum.
Corollary 2: E[N_done^(k)]   = N * lambda_k / lambda_sum.

Under the oracle's assumptions (full data everywhere, perfect coordination,
nobody idle, no overlap) the K independent Poisson service processes merge
into one Poisson process of rate lambda_sum, so the completion time of N
units is Gamma(N, lambda_sum)-distributed.  ``oracle_time_samples`` exploits
that identity for exact Monte-Carlo sampling; ``oracle_mean_time_enumerated``
evaluates the paper's finite sum (eqs. 8-12) term by term, which is used in
tests to confirm the telescoping to N/lambda_sum.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from .types import HetSpec


def oracle_mean_time(het: HetSpec, N: int) -> float:
    """Theorem 1 closed form."""
    return N / het.lambda_sum


def oracle_expected_done(het: HetSpec, N: int) -> np.ndarray:
    """Corollary 2: water-filling-like proportional split."""
    return N * het.lambdas / het.lambda_sum


def oracle_time_samples(het: HetSpec, N: int, trials: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Exact samples of T_comp^oracle = N-th arrival of the merged process."""
    return rng.gamma(shape=N, scale=1.0 / het.lambda_sum, size=trials)


def oracle_mean_time_enumerated(het: HetSpec, N: int) -> float:
    """Paper eqs. (10)-(11): E[T] = sum over {n: n_sum < N} of
    (1/lam_sum) * multinomial(n_sum; n) * prod_k (lam_k/lam_sum)^{n_k}.

    Exponential-cost enumeration -- only for small N, K (tests of Thm 1's
    internal consistency: the sum telescopes to N/lambda_sum).
    """
    lam = het.lambdas
    K = het.K
    lam_sum = het.lambda_sum
    p = lam / lam_sum
    total = 0.0
    # enumerate all n with n_1 + ... + n_K = n for n in [0, N)
    for n in range(N):
        for comp in _compositions(n, K):
            coef = math.factorial(n)
            for c in comp:
                coef //= math.factorial(c)
            total += coef * float(np.prod(p ** np.array(comp)))
    return total / lam_sum


def _compositions(n: int, k: int):
    """All k-tuples of non-negative ints summing to n."""
    if k == 1:
        yield (n,)
        return
    for first in range(n + 1):
        for rest in _compositions(n - first, k - 1):
            yield (first,) + rest
