"""Serving step factories and greedy generation: prefill the prompt, then
decode one token a step with the cache.  The port of
``repro.train.serve``: PyTorch runs eagerly, so the factories return the
model's own calls (the JAX package jits them and donates the cache; a
captured decode step is later work).

On a mesh (``distributed.sharding.use_mesh``) ``greedy_generate`` takes
the whole prompt batch on every rank, runs each step on this rank's
block of it (the batch over the data axes) and returns the whole token
array on every rank; the cache it takes and returns is this rank's.  A
batch that the data axes do not divide raises: the JAX package keeps
such a batch whole on every data rank (``batch_specs(batch_shardable=
False)``, the sequence of its cache over 'data'), which the port does
not do.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..distributed import collectives as coll
from ..distributed.sharding import (BATCH_AXES, active_mesh, axis_size,
                                    shard_batch)
from ..models.moe import math_prod


def make_prefill_step(model, mode: str = "unroll") -> Callable:
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache, mode=mode)
    return prefill_step


def make_decode_step(model, mode: str = "unroll") -> Callable:
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens, mode=mode)
    return decode_step


def greedy_generate(model, params, prompt_batch, cache, steps: int,
                    mode: str = "unroll"):
    """Returns ``(tokens (B, steps), cache)``."""
    mesh = active_mesh()
    if mesh is not None:
        dp = math_prod(axis_size(a) for a in BATCH_AXES)
        B = next(iter(prompt_batch.values())).shape[0]
        if B % dp:
            raise ValueError(
                f"greedy_generate on a mesh shards the batch over its data "
                f"axes: a batch of {B} does not split over {dp} data ranks "
                f"(a batch kept whole on every data rank is not supported)")
        prompt_batch = shard_batch(prompt_batch)
    prefill = make_prefill_step(model, mode)
    decode = make_decode_step(model, mode)
    logits, cache = prefill(params, prompt_batch, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = decode(params, cache, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if mesh is not None:
        toks = coll.all_gather(toks, BATCH_AXES, dim=0)
    return toks, cache
