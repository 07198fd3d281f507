"""Coded-computation baselines in executable form: the port's own copy of
``repro.core.coded`` (host numpy).

1. ``MDSCodedMatmul`` -- the paper's original setting: (K, L) MDS-coded
   distributed matrix-vector multiplication with a real Vandermonde encode
   and a real decode from ANY L of K replies (Section 3 / Figure 1a).

2. ``GradientCoding``  -- the ML analogue for non-linear work: the gradient
   *sum* is linear in per-unit gradients, so a fractional-repetition code
   over units lets the master recover the exact full-batch gradient from
   any (K - s) workers (tolerating s stragglers).  This is the natural
   translation of the paper's MDS baseline to training.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


# ---------------------------------------------------------------------------
# (K, L) MDS coded matmul
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MDSCodedMatmul:
    """Encode A (rows) into K coded chunks; decode Ax from any L replies."""

    K: int
    L: int

    def encode(self, A: np.ndarray) -> List[np.ndarray]:
        n = A.shape[0]
        if n % self.L:
            pad = self.L - n % self.L
            A = np.concatenate([A, np.zeros((pad, *A.shape[1:]), A.dtype)], 0)
        self._orig_rows = n
        chunks = np.stack(np.split(A, self.L, axis=0))     # (L, n/L, d)
        # Vandermonde generator: row k of G codes chunk-space -> worker k
        alphas = np.arange(1, self.K + 1, dtype=np.float64)
        self.G = np.vander(alphas, N=self.L, increasing=True)  # (K, L)
        return [np.tensordot(self.G[k], chunks, axes=(0, 0))
                for k in range(self.K)]

    def decode(self, replies: dict[int, np.ndarray]) -> np.ndarray:
        """replies: worker index -> coded chunk result (any >= L of them)."""
        if len(replies) < self.L:
            raise ValueError(f"need >= {self.L} replies, got {len(replies)}")
        idx = sorted(replies)[: self.L]
        Gs = self.G[idx]                                   # (L, L)
        Y = np.stack([replies[i] for i in idx])            # (L, m, ...)
        flat = Y.reshape(self.L, -1)
        decoded = np.linalg.solve(Gs, flat).reshape(Y.shape)
        out = np.concatenate(list(decoded), axis=0)
        return out[: self._orig_rows]


# ---------------------------------------------------------------------------
# fractional-repetition gradient coding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GradientCoding:
    """Fractional-repetition gradient code tolerating ``s`` stragglers.

    Requires (s+1) | K.  Workers are split into s+1 replica groups; each
    group partitions the units.  Every unit is computed by exactly s+1
    workers; the master recovers the exact gradient sum from any K-s
    replies by, per unit, using one surviving owner.
    """

    K: int
    s: int

    def __post_init__(self):
        if self.K % (self.s + 1):
            raise ValueError("fractional repetition needs (s+1) | K")
        self.group_size = self.K // (self.s + 1)

    def assignment(self, n_units: int) -> List[List[int]]:
        """unit ids owned by each worker (len K)."""
        units = list(range(n_units))
        per = [[] for _ in range(self.K)]
        for g in range(self.s + 1):               # replica group g
            for i, u in enumerate(units):
                w = g * self.group_size + (i % self.group_size)
                per[w].append(u)
        return per

    def decode(self, n_units: int, replies: dict[int, dict[int, np.ndarray]]
               ) -> np.ndarray:
        """replies: worker -> {unit id -> gradient (flat np array)}.

        Any K - s workers suffice; raises if some unit is uncovered.
        """
        covered: dict[int, np.ndarray] = {}
        for w, grads in replies.items():
            for u, g in grads.items():
                covered.setdefault(u, g)
        missing = [u for u in range(n_units) if u not in covered]
        if missing:
            raise ValueError(f"units {missing} uncovered by replies")
        return np.sum(np.stack([covered[u] for u in range(n_units)]), axis=0)

    def redundancy_factor(self) -> float:
        return float(self.s + 1)
