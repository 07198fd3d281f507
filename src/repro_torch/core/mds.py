"""Optimized (K, L) MDS-coded computation baseline (paper Section 3): the
port's copy of ``repro.core.mds``.

Two evaluation paths:
  * exact      -- eq. (3)-(6) via the Erlang order-statistics recursion
                  (``core.erlang``); tractable for small K and m = N/L.
  * monte carlo -- ``core.simulator.mds_optimize``; used at paper scale
                  (N = 1e6), where the combinatorial formula is infeasible
                  (the paper's own simulations are MC as well).  It draws
                  with the exact numpy engine on the host and, as every
                  Monte-Carlo entry point of the port, resolves ``device``.
"""
from __future__ import annotations

import numpy as np

from ..device import DEFAULT_DEVICE
from . import erlang, simulator
from .types import HetSpec


def mds_mean_time_exact(het: HetSpec, N: int, L: int) -> float:
    """E[T^MDS(L)] = mu_(L, ceil(N/L)) -- exact, small instances only."""
    m = int(np.ceil(N / L))
    return erlang.erlang_order_stat_mean(het, m, L)


def mds_optimize_exact(het: HetSpec, N: int) -> tuple[int, float]:
    """Eq. (6) with the exact recursion."""
    best = (1, np.inf)
    for L in range(1, het.K + 1):
        t = mds_mean_time_exact(het, N, L)
        if t < best[1]:
            best = (L, t)
    return best


def mds_optimize_mc(het: HetSpec, N: int, trials: int,
                    rng: np.random.Generator,
                    device=DEFAULT_DEVICE) -> tuple[int, float]:
    return simulator.mds_optimize(het, N, trials, rng, device=device)
