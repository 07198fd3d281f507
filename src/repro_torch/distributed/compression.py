"""Gradient compression for the worker->master hop (beyond-paper): the
port of ``repro.distributed.compression``.

The paper trades computation time against coordination/communication; in
training, the dominant recurring payload is the gradient.  Two standard
compressors with ERROR FEEDBACK (the residual is re-added next round so
compression error does not bias the trajectory asymptotically):

  * Int8Compressor -- per-tensor symmetric int8 quantization (4x vs f32)
  * TopKCompressor -- magnitude top-k sparsification (k-fraction kept)

``roundtrip`` returns (decompressed_gradient, wire_bytes): the trainer
accumulates exactly what the master would reconstruct.  Each leaf is
worked in float32 on the device it lies on, with the reference's
operations in its order; the wire bytes count what the reference counts
(int8 payload + scale; k values + k int32 indices).

A worker's stored residual is the buffer its next round works in: the
residual plus the new gradient is summed into it in place (the same bits
as the reference's ``grads + residual``) and the new residual is left
there, so error feedback holds one float32 tree a worker and no more.
The caller's gradient tree is never written.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..optim.adamw import tree_leaves, tree_map


class _ErrorFeedback:
    def __init__(self):
        self._residual: Dict[int, List[torch.Tensor]] = {}

    def take(self, worker: int):
        """The worker's residual leaves (None before its first round),
        handed over to be worked in place until ``store``."""
        return self._residual.pop(worker, None)

    def store(self, worker: int, residual: List[torch.Tensor]):
        self._residual[worker] = residual


def _roundtrip(grads, worker: int, ef, comp):
    """``comp(leaf) -> (out, wire bytes)`` on each float32 leaf of
    ``grads`` (plus the worker's residual under error feedback); returns
    ``(out tree, total wire bytes)`` and stores the new residuals."""
    res = None if ef is None else ef.take(worker)
    outs, new_res, nbytes = [], [], 0
    for i, g in enumerate(tree_leaves(grads)):
        x = g.float() if res is None else res[i].add_(g)
        out, nb = comp(x)
        outs.append(out)
        nbytes += nb
        if ef is not None:      # the residual: in x where x is ours
            new_res.append(x - out if res is None else x.sub_(out))
    if ef is not None:
        ef.store(worker, new_res)
    it = iter(outs)
    return tree_map(lambda _: next(it), grads), float(nbytes)


def _kth_largest(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of non-negative float32 values (the reference's
    ``sort(|g|)[-k]``), by bisection on their bit patterns, whose integer
    order is the values' order: the largest pattern t with at least k
    patterns >= t is the k-th largest value's.  Exact, and no sort or
    top-k buffer of the leaf's size."""
    bits = mag.reshape(-1).view(torch.int32)
    lo, hi = 0, 0x7F800001          # count(>= lo) >= k > count(>= hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if int((bits >= mid).sum()) >= k:
            lo = mid
        else:
            hi = mid
    return torch.tensor(lo, dtype=torch.int32).view(torch.float32).to(
        mag.device)


class Int8Compressor:
    """Symmetric per-tensor int8 with error feedback."""

    def __init__(self, error_feedback: bool = True):
        self.ef = _ErrorFeedback() if error_feedback else None

    def roundtrip(self, grads, worker: int):
        def comp(g32):
            scale = torch.clamp(torch.linalg.vector_norm(g32, float("inf")),
                                min=1e-12) / 127.0
            t = g32 / scale
            q = t.round_().clamp_(-127, 127).to(torch.int8)
            del t
            return q.float().mul_(scale), q.numel() + 4  # payload + scale

        return _roundtrip(grads, worker, self.ef, comp)


class TopKCompressor:
    """Keep the top-k fraction by magnitude; error feedback on the rest."""

    def __init__(self, frac: float = 0.1, error_feedback: bool = True):
        self.frac = float(frac)
        self.ef = _ErrorFeedback() if error_feedback else None

    def roundtrip(self, grads, worker: int):
        def comp(g32):
            mag = g32.abs()
            k = max(1, int(self.frac * mag.numel()))
            keep = mag >= _kth_largest(mag, k)
            del mag
            # wire: k values + k int32 indices
            return torch.where(keep, g32, 0.0), 8 * k

        return _roundtrip(grads, worker, self.ef, comp)


__all__ = ["Int8Compressor", "TopKCompressor"]
