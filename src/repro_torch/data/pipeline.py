"""Heterogeneity-aware data pipeline: the port's copy of
``repro.data.pipeline`` (pure numpy).

``UnitStore`` maps unit ids to microbatch contents (synthetic here; a
sharded object store in production).  ``HetShardedLoader`` tracks, per
training step, which worker group owns which units; re-ownership between
steps is decided by the work-exchange scheduler and the loader counts the
re-fetch traffic (the paper's N_comm, eq. 1-2, in tokens)."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from .synthetic import structured_unit, unit_tokens


@dataclasses.dataclass
class UnitStore:
    unit_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    structured: bool = False

    def fetch(self, unit_id: int) -> dict:
        fn = structured_unit if self.structured else unit_tokens
        return fn(unit_id, self.unit_batch, self.seq_len, self.vocab,
                  self.seed)

    def tokens_per_unit(self) -> int:
        return self.unit_batch * self.seq_len


class HetShardedLoader:
    """Tracks unit ownership across steps; counts re-fetch traffic."""

    def __init__(self, store: UnitStore, n_workers: int):
        self.store = store
        self.K = n_workers
        self._owned: List[set] = [set() for _ in range(n_workers)]
        self.refetched_units = 0
        self.refetched_tokens = 0

    def assign(self, worker: int, unit_ids: Sequence[int]) -> List[dict]:
        """Feed units to a worker; fetch-and-count those it doesn't hold."""
        out = []
        for u in unit_ids:
            if u not in self._owned[worker]:
                self.refetched_units += 1
                self.refetched_tokens += self.store.tokens_per_unit()
                self._owned[worker].add(u)
            out.append(self.store.fetch(u))
        return out

    def touch(self, worker: int, unit_ids: Sequence[int]) -> None:
        """Ownership/refetch accounting without materializing batches --
        what the batched scan engine uses (it fetches units itself, in
        canonical order, one stacked dispatch per group)."""
        for u in unit_ids:
            if u not in self._owned[worker]:
                self.refetched_units += 1
                self.refetched_tokens += self.store.tokens_per_unit()
                self._owned[worker].add(u)

    def prefetch(self, worker: int, unit_ids: Sequence[int]) -> None:
        """Initial placement (not counted -- paper counts from epoch 2)."""
        self._owned[worker].update(unit_ids)

    def evict(self, worker: int) -> None:
        self._owned[worker].clear()
