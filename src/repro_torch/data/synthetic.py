"""Deterministic synthetic data: seeded token streams per (epoch, unit).
The port's copy of ``repro.data.synthetic`` (pure numpy): a unit's
content is byte-equal to the JAX package's.

Units are addressable by id so the work-exchange scheduler can ship them
between workers without coordination beyond the id (the "sharded data
store" of DESIGN §3): unit id -> deterministic content, anywhere.
"""
from __future__ import annotations

import numpy as np


def unit_tokens(unit_id: int, batch: int, seq_len: int, vocab: int,
                seed: int = 0) -> dict:
    """One microbatch unit: (tokens, labels) with next-token labels."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, unit_id]))
    toks = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int64)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def structured_unit(unit_id: int, batch: int, seq_len: int, vocab: int,
                    seed: int = 0) -> dict:
    """Learnable synthetic task: next token = (3 * tok + 7) % vocab with
    occasional noise -- a model must actually learn to reduce this loss
    (used by the end-to-end training example to show loss descent)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, unit_id, 1]))
    first = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    toks = np.empty((batch, seq_len + 1), dtype=np.int64)
    toks[:, :1] = first
    for t in range(1, seq_len + 1):
        toks[:, t] = (3 * toks[:, t - 1] + 7) % vocab
    noise = rng.random((batch, seq_len + 1)) < 0.02
    toks[noise] = rng.integers(0, vocab, size=int(noise.sum()))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
