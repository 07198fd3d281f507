"""Fault-injection wrapper transport: latency, jitter, seeded drops.
The port's own copy of ``repro.control.faults``.

``flaky`` wraps any inner transport (default ``inproc``) and perturbs
every ``send`` on both sides of every channel:

* ``delay`` + ``jitter``: per-message latency ``delay + U(0, jitter)``
  seconds, applied inline before handing the message to the inner comm
  (so per-channel FIFO order is preserved -- latency, not reordering);
* ``drop``: with probability ``drop`` the message is silently lost (the
  paper's control messages are tiny; loss, not corruption, is the
  realistic failure) -- which is exactly what exercises the
  coordinator's timeout + retry-with-backoff path and the worker-side
  seq dedup.

Draws come from one seeded ``default_rng`` per transport instance, so a
given message sequence sees a reproducible fault pattern -- the
reference's pattern, since the draws come in the reference's order.
"""
from __future__ import annotations

import asyncio
from typing import Dict, Optional

import numpy as np

from .transport import (Comm, HandleComm, Listener, Transport,
                        get_transport, register_transport)


class FlakyComm(Comm):
    def __init__(self, inner: Comm, rng: np.random.Generator,
                 delay: float, jitter: float, drop: float):
        self._inner = inner
        self._rng = rng
        self._delay = delay
        self._jitter = jitter
        self._drop = drop
        self.dropped = 0          # messages this side silently lost
        self._sent = 0

    async def send(self, msg: Dict) -> None:
        # the first message each side sends is its connection handshake
        # (hello / first reply): delivered faithfully, like a TCP accept
        # -- faults apply to the conversation, not to establishment
        self._sent += 1
        if self._sent == 1:
            await self._inner.send(msg)
            return
        if self._drop > 0.0 and self._rng.random() < self._drop:
            self.dropped += 1
            return
        lag = self._delay + (self._jitter * float(self._rng.random())
                             if self._jitter > 0.0 else 0.0)
        if lag > 0.0:
            await asyncio.sleep(lag)
        await self._inner.send(msg)

    async def recv(self, timeout: Optional[float] = None) -> Dict:
        return await self._inner.recv(timeout)

    async def close(self) -> None:
        await self._inner.close()

    @property
    def closed(self) -> bool:
        return self._inner.closed


@register_transport("flaky", aliases=("faulty",))
class FlakyTransport(Transport):
    """Latency/jitter/drop wrapper around an inner transport."""

    def __init__(self, inner: str = "inproc", delay: float = 0.0,
                 jitter: float = 0.0, drop: float = 0.0, seed: int = 0):
        if not 0.0 <= float(drop) < 1.0:
            raise ValueError(f"drop must be in [0, 1); got {drop}")
        if float(delay) < 0.0 or float(jitter) < 0.0:
            raise ValueError("delay and jitter must be >= 0")
        self._inner = get_transport(inner)
        self.delay = float(delay)
        self.jitter = float(jitter)
        self.drop = float(drop)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)

    def _wrap(self, comm: Comm) -> FlakyComm:
        return FlakyComm(comm, self._rng, self.delay, self.jitter,
                         self.drop)

    def listen(self, handle_comm: HandleComm,
               address: Optional[str] = None) -> Listener:
        async def handle_wrapped(comm: Comm) -> None:
            await handle_comm(self._wrap(comm))
        return self._inner.listen(handle_wrapped, address)

    async def connect(self, address: str) -> Comm:
        return self._wrap(await self._inner.connect(address))


__all__ = ["FlakyComm", "FlakyTransport"]
