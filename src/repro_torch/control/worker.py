"""Live worker: executes assigned unit queues over a transport Comm.  The
port's own copy of ``repro.control.worker``.

One ``Worker`` connects to the coordinator's listener, announces itself
with a ``hello`` push, then serves RPCs sequentially:

``assign``
    Start a round: draw per-unit service times from the worker's
    Exp(1/lambda_k) model clock, run the REAL matmul for the whole queue
    (one gather and one product on the payload's device, which the
    worker does not wait for), then sleep out the remainder of the drawn
    wall-time budget; push ``round_done`` when the clock runs out.
``poll``
    Report instantaneous progress: how many units of the current queue
    are complete *right now* (``searchsorted`` on the drawn cumulative
    unit clocks -- the exact Poisson-process count at the poll instant).
``stop``
    Freeze the round at the stop instant and reply with the final done
    count (the paper's stop-flag message).
``shutdown``
    Acknowledge and exit the serve loop.

Replies echo the request's ``seq``; a seq seen before is answered from
a reply cache, so coordinator retries over lossy transports are
idempotent (a retried ``stop`` gets the count frozen by the first one).

Fault injection: ``die_after`` seconds after starting, the worker
silently cancels its serve loop WITHOUT closing the comm -- from the
coordinator's side it just stops answering, which is what exercises the
timeout/retry/mark-lost path rather than a clean close.
"""
from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np

from .compute import MatmulPayload
from .telemetry import Telemetry
from .transport import CommClosedError, Transport


class Worker:
    """One live worker endpoint (its own asyncio task)."""

    def __init__(self, transport: Transport, address: str, wid: int,
                 rate: float, time_scale: float, payload: MatmulPayload,
                 seed: int = 0, telemetry: Optional[Telemetry] = None,
                 die_after: Optional[float] = None):
        self.transport = transport
        self.address = address
        self.wid = int(wid)
        self.rate = float(rate)
        self.time_scale = float(time_scale)
        self.payload = payload
        self.telemetry = telemetry
        self.die_after = die_after
        self._rng = np.random.default_rng(seed)
        self._replies: Dict[int, Dict] = {}     # seq -> reply (dedup)
        self._round = -1
        self._units: List[int] = []
        self._cum = np.zeros(0)                 # per-unit wall deadlines
        self._round_t0 = 0.0
        self._running = False
        self._frozen_done = 0
        self._round_task: Optional[asyncio.Future] = None
        self._dead = False
        self.comm = None

    # -- progress accounting ------------------------------------------------

    def _done_now(self) -> int:
        """Units of the current queue complete at this wall instant."""
        if self._round < 0:
            return 0
        if not self._running:
            return self._frozen_done
        t = time.perf_counter() - self._round_t0
        return int(np.searchsorted(self._cum, t, side="right"))

    def _freeze(self) -> int:
        done = self._done_now()
        self._running = False
        self._frozen_done = done
        if self._round_task is not None and not self._round_task.done():
            self._round_task.cancel()
        if self.telemetry is not None:
            self.telemetry.span_close(self.wid, units=done)
            self.telemetry.span_open(self.wid, "idle")
        return done

    # -- round execution ----------------------------------------------------

    def _start_round(self, rnd: int, units: List[int]) -> None:
        self._round = int(rnd)
        # kept as sent, not copied (a message is not mutated after send):
        # the workers start one after another on one event loop, so a
        # copy here would delay every later worker's clock
        self._units = units
        times = (self._rng.exponential(1.0 / self.rate, len(units))
                 if units else np.zeros(0))
        self._cum = np.cumsum(times) * self.time_scale
        self._round_t0 = time.perf_counter()
        self._running = True
        self._frozen_done = 0
        if self.telemetry is not None:
            self.telemetry.span_open(self.wid, "busy", round=self._round)
        self._round_task = asyncio.ensure_future(self._run_round())

    async def _run_round(self) -> None:
        rnd, units = self._round, self._units
        # real FLOPs first (one device call for the whole queue, not
        # waited for), then sleep out the drawn service clock's remainder
        self.payload.compute(units)
        target = float(self._cum[-1]) if len(units) else 0.0
        remain = target - (time.perf_counter() - self._round_t0)
        if remain > 0:
            await asyncio.sleep(remain)
        self._running = False
        self._frozen_done = len(units)
        if self.telemetry is not None:
            self.telemetry.span_close(self.wid, units=len(units))
            self.telemetry.span_open(self.wid, "idle")
        try:
            await self.comm.send({"type": "round_done", "worker": self.wid,
                                  "round": rnd, "done": len(units)})
        except CommClosedError:
            pass

    # -- RPC dispatch -------------------------------------------------------

    def _handle(self, msg: Dict) -> Dict:
        kind = msg.get("type")
        if kind == "assign":
            self._start_round(msg["round"], msg["units"])
            return {"ok": True, "n": len(self._units)}
        if kind == "poll":
            return {"round": self._round, "done": self._done_now(),
                    "running": self._running}
        if kind == "stop":
            done = self._freeze() if self._running else self._frozen_done
            return {"round": self._round, "done": done}
        if kind == "shutdown":
            return {"ok": True}
        return {"error": f"unknown rpc {kind!r}"}

    async def _serve(self) -> None:
        while True:
            msg = await self.comm.recv()
            seq = msg.get("seq")
            if seq in self._replies:
                reply = self._replies[seq]       # retried rpc: idempotent
            else:
                reply = {"type": "reply", "seq": seq, **self._handle(msg)}
                self._replies[seq] = reply
            await self.comm.send(reply)
            if msg.get("type") == "shutdown":
                return

    async def _die(self) -> None:
        await asyncio.sleep(self.die_after)
        self._dead = True
        if self.telemetry is not None:
            self.telemetry.event("worker_died", worker=self.wid)
            self.telemetry.span_close(self.wid)
        if self._round_task is not None and not self._round_task.done():
            self._round_task.cancel()
        self._serve_task.cancel()

    async def run(self) -> None:
        self.comm = await self.transport.connect(self.address)
        if self.telemetry is not None:
            self.telemetry.span_open(self.wid, "idle")
        await self.comm.send({"type": "hello", "worker": self.wid})
        self._serve_task = asyncio.ensure_future(self._serve())
        killer = (asyncio.ensure_future(self._die())
                  if self.die_after is not None else None)
        try:
            await self._serve_task
        except (asyncio.CancelledError, CommClosedError):
            pass
        finally:
            if killer is not None:
                killer.cancel()
            if self._round_task is not None and not self._round_task.done():
                self._round_task.cancel()
            if not self._dead and self.comm is not None:
                # a DEAD worker leaves its comm open: silence, not a
                # clean close, is what the coordinator must survive
                await self.comm.close()


__all__ = ["Worker"]
