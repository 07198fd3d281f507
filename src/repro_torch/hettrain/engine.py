"""Unit-group gradient engine: the port of ``repro.hettrain.engine``.

``grad_sum`` takes a group of unit ids and returns the float32 SUM of
the units' gradients and their losses.  The JAX engine stacks the group
on a leading axis and folds ``value_and_grad`` over it in one jitted
``lax.scan``; PyTorch runs eagerly, so here the fold is a Python loop,
one ``torch.autograd.grad`` per unit, each added in float32 into a zeros
tree.  The two properties the training subsystem leans on stay:

* **canonical order**: the ids are sorted before anything is computed,
  so a group's sum is bit-identical whichever order its units came in;
* **pow2 unit-count bucketing** (``bucket_units``): the JAX engine pads
  a group to the next power of two (floor ``MIN_BUCKET``) by repeating
  the last unit under a zero mask, so that groups share compiled
  shapes, and adds ``g * 0.0``, exactly 0, for each pad slot.  Eager
  PyTorch has no compiled shapes, so this engine computes no pad slot:
  the sum is the same bits as the padded one (adding +-0 to a float32
  sum that starts at +0 changes no bit).  ``bucket_sizes`` still records
  the bucket each call would have taken, so ``stats()`` equals the JAX
  engine's after the same calls.

The units' batches go to the params' device, as ``train.loop``'s steps
move theirs.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..optim.adamw import tree_leaves, tree_map
from ..train.loop import _device_of, _grad_of, _on_device

MIN_BUCKET = 4


def bucket_units(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Next power-of-two group size >= n (floor ``min_bucket``)."""
    if n <= 0:
        raise ValueError("bucket_units needs n >= 1")
    b = max(int(min_bucket), 1)
    while b < n:
        b *= 2
    return b


def tree_bytes(tree) -> float:
    """Dense byte size of one gradient tree (the uncompressed wire cost)."""
    return float(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


class ScanGradEngine:
    """A unit group -> (float32 grad sum, losses in sorted-id order).

    One instance per (model, store); the counters are the JAX engine's:
    ``dispatches`` (calls), ``units_in`` (real units summed) and
    ``bucket_sizes`` (the distinct padded group sizes)."""

    def __init__(self, model, store, min_bucket: int = MIN_BUCKET):
        self.model = model
        self.store = store
        self.min_bucket = int(min_bucket)
        self.dispatches = 0
        self.units_in = 0
        self.bucket_sizes: set = set()

    def grad_sum(self, params, unit_ids: Sequence[int]):
        """(float32 gradient SUM over the group, per-unit losses (float32
        numpy) in canonical sorted-id order).  Divide by the step's unit
        count at the caller: partial groups stay sums so they compose."""
        ids = sorted(int(u) for u in unit_ids)
        bucket = bucket_units(len(ids), self.min_bucket)
        device = _device_of(params)
        acc = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        losses = []
        for u in ids:
            batch = _on_device(self.store.fetch(u), device)
            loss, _, grads = _grad_of(self.model, params, batch, "scan",
                                      False)
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g.float())
            losses.append(loss)
            del grads           # before the next unit's backward
        self.dispatches += 1
        self.units_in += len(ids)
        self.bucket_sizes.add(bucket)
        return acc, torch.stack(losses).float().cpu().numpy()

    def stats(self) -> Dict[str, float]:
        return {"dispatches": self.dispatches, "units": self.units_in,
                "bucket_sizes": sorted(self.bucket_sizes)}


__all__ = ["ScanGradEngine", "bucket_units", "tree_bytes", "MIN_BUCKET"]
