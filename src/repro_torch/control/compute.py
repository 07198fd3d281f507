"""The live workers' real payload: row-block shards of one A @ x, held on
a torch device.  The port of ``repro.control.compute``.

Unit ``u`` is the row block ``A[u*rows:(u+1)*rows]``.  ``A`` and ``x``
are drawn with numpy exactly as the reference draws them, so one seed
gives the same bits, and are then held on the device as ``A`` ``(units,
unit_rows, unit_dim)`` float32, ``x`` ``(unit_dim,)`` and ``y`` ``(units,
unit_rows)``.  A worker assigned a queue of units computes it in ONE
gather and ONE product on the device per round; the host only marks
``done`` and counts ``flops``.  The reference pads each queue to a
power-of-two unit count to bound jit retraces; torch does not retrace,
so the port does not pad.

Nothing in ``compute`` waits for the device: the unit ids go up from
pinned memory without blocking, and the drawn Exp(1/lambda_k) service
clock -- not the product's time -- governs the worker's pacing (it
sleeps out the remainder), so the executed run matches the paper's
service model statistically while still doing real FLOPs.  On a CUDA
device each call is bracketed by CUDA events, read after the episode by
``device_ms``.  There is no numpy fallback: the payload runs where
``device`` says, and the port's default device raises without a card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

# rows of A drawn (and copied to the device) at a time: the numpy stream
# is the reference's whatever the chunking, and the host holds one chunk
# of float64 at a time instead of the whole A
_DRAW_ROWS = 1 << 20


class MatmulPayload:
    """One shared ``A @ x`` product, computed live in unit row-blocks."""

    def __init__(self, units: int, unit_rows: int, unit_dim: int,
                 seed: int = 0, device=DEFAULT_DEVICE):
        self.units = int(units)
        self.unit_rows = int(unit_rows)
        self.unit_dim = int(unit_dim)
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        rows = self.units * self.unit_rows
        self.A = torch.empty((self.units, self.unit_rows, self.unit_dim),
                             dtype=torch.float32, device=self.device)
        flat = self.A.view(rows, self.unit_dim)
        for r0 in range(0, rows, _DRAW_ROWS):
            n = min(_DRAW_ROWS, rows - r0)
            chunk = rng.standard_normal((n, self.unit_dim)).astype(
                np.float32)
            flat[r0:r0 + n].copy_(torch.from_numpy(chunk))
        self.x = torch.from_numpy(
            rng.standard_normal(self.unit_dim).astype(np.float32)).to(
                self.device)
        self.y = torch.zeros((self.units, self.unit_rows),
                             dtype=torch.float32, device=self.device)
        self.done = np.zeros(self.units, dtype=bool)
        self.flops = 0              # multiply-adds issued so far
        self.backend = "torch"
        self._events: Optional[List[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]] = (
            [] if self.device.type == "cuda" else None)

    def _ids_on_device(self, ids: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(ids)
        if self.device.type != "cuda":
            return host
        # pinned and non-blocking: the copy never waits for the device
        return host.pin_memory().to(self.device, non_blocking=True)

    def compute(self, unit_ids: Sequence[int]) -> Tuple[int, int]:
        """Compute the blocks for ``unit_ids``; returns (units, rows)."""
        if len(unit_ids) == 0:
            return 0, 0
        ids = np.fromiter(unit_ids, dtype=np.int64,
                          count=len(unit_ids)) % self.units
        idx = self._ids_on_device(ids)
        if self._events is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        block = self.A.index_select(0, idx)
        self.y.index_copy_(0, idx, torch.matmul(block, self.x))
        if self._events is not None:
            end.record()
            self._events.append((start, end))
        self.done[ids] = True
        rows = len(unit_ids) * self.unit_rows
        self.flops += rows * self.unit_dim
        return len(unit_ids), rows

    def warmup(self, max_units: int) -> None:
        """Calls at every power of four below the episode's largest queue
        and at the largest, ahead of the episode clock, so no first-call
        cost lands in a measured span: the gather, the product and the
        scatter pick their kernels by size, and a kernel's first launch
        is slow (a 16-unit call inside an episode took 84.5 ms once on
        an NVIDIA H100 80GB HBM3, 700.00 W, when the warm-up made one
        call at the largest queue only)."""
        top = min(int(max_units), self.units)
        n = 1
        while n < top:
            self.compute(list(range(n)))
            n *= 4
        self.compute(list(range(top)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.done[:] = False
        self.flops = 0
        if self._events is not None:
            self._events.clear()

    def device_ms(self) -> Optional[float]:
        """Device milliseconds of every ``compute`` since ``warmup``
        (waits for the device), or ``None`` off a CUDA device."""
        if self._events is None:
            return None
        torch.cuda.synchronize(self.device)
        return float(sum(s.elapsed_time(e) for s, e in self._events))

    def verify(self) -> bool:
        """Every computed block matches a float64 product on the device."""
        if not self.done.any():
            return True
        idx = torch.from_numpy(np.nonzero(self.done)[0]).to(self.device)
        ref = torch.matmul(self.A.index_select(0, idx).double(),
                           self.x.double())
        got = self.y.index_select(0, idx).double()
        return bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-4))


__all__ = ["MatmulPayload"]
