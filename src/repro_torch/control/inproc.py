"""In-process transport: asyncio queue pairs behind the Comm contract.
The port's own copy of ``repro.control.inproc``.

The shape of dask.distributed's ``comm/inproc.py`` without the
cross-thread machinery: a process-global table maps ``inproc://<n>``
addresses to listeners; ``connect`` builds two unbounded queues (one per
direction) and hands the server-side peer to the listener's
``handle_comm`` as its own task.  Delivery is FIFO per direction and
never drops -- the reference behaviour every other transport's
conformance run is measured against.
"""
from __future__ import annotations

import asyncio
import itertools
from typing import Dict, Optional

from .transport import (Comm, CommClosedError, HandleComm, Listener,
                        Transport, register_transport)

_ADDRESS_COUNTER = itertools.count()
_LISTENERS: Dict[str, "InProcListener"] = {}

_CLOSE = object()      # end-of-channel sentinel


class InProcComm(Comm):
    """One endpoint of an in-process channel (a queue pair)."""

    def __init__(self, send_q: asyncio.Queue, recv_q: asyncio.Queue,
                 label: str):
        self._send_q = send_q
        self._recv_q = recv_q
        self.label = label
        self._closed = False
        self._peer_closed = False

    async def send(self, msg: Dict) -> None:
        if self._closed or self._peer_closed:
            raise CommClosedError(f"{self.label}: channel closed")
        self._send_q.put_nowait(msg)

    async def recv(self, timeout: Optional[float] = None) -> Dict:
        if self._peer_closed and self._recv_q.empty():
            raise CommClosedError(f"{self.label}: peer closed")
        if self._closed:
            raise CommClosedError(f"{self.label}: channel closed")
        get = self._recv_q.get()
        msg = await (asyncio.wait_for(get, timeout) if timeout is not None
                     else get)
        if msg is _CLOSE:
            self._peer_closed = True
            raise CommClosedError(f"{self.label}: peer closed")
        return msg

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._send_q.put_nowait(_CLOSE)

    @property
    def closed(self) -> bool:
        return self._closed or self._peer_closed


class InProcListener(Listener):
    def __init__(self, address: str, handle_comm: HandleComm):
        self.address = address
        self._handle_comm = handle_comm
        self._tasks: list = []
        self._started = False

    async def start(self) -> None:
        _LISTENERS[self.address] = self
        self._started = True

    async def stop(self) -> None:
        _LISTENERS.pop(self.address, None)
        self._started = False
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()

    def _accept(self) -> Comm:
        """Build a channel pair; serve one end, return the other."""
        a_to_b: asyncio.Queue = asyncio.Queue()
        b_to_a: asyncio.Queue = asyncio.Queue()
        server = InProcComm(b_to_a, a_to_b, f"{self.address}#server")
        client = InProcComm(a_to_b, b_to_a, f"{self.address}#client")
        self._tasks.append(asyncio.ensure_future(
            self._handle_comm(server)))
        return client


@register_transport("inproc")
class InProcTransport(Transport):
    """Reference transport: lossless ordered in-process delivery."""

    def listen(self, handle_comm: HandleComm,
               address: Optional[str] = None) -> Listener:
        if address is None:
            address = f"inproc://{next(_ADDRESS_COUNTER)}"
        return InProcListener(address, handle_comm)

    async def connect(self, address: str) -> Comm:
        listener = _LISTENERS.get(address)
        if listener is None or not listener._started:
            raise CommClosedError(f"no inproc listener at {address!r}")
        return listener._accept()


__all__ = ["InProcComm", "InProcListener", "InProcTransport"]
