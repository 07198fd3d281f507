"""TCP localhost transport: asyncio streams behind the Comm contract.  The
port's own copy of ``repro.control.tcp``, with one repair (below).

The first transport that crosses a real socket: ``listen`` binds an
``asyncio.start_server`` on ``127.0.0.1`` (port 0 -- the OS picks;
``address`` is concrete only after ``start()``), ``connect`` opens a
stream to ``tcp://host:port``.  Messages are JSON documents in 4-byte
big-endian length-prefixed frames -- dask.distributed's framing shape
without the multi-frame machinery, which the control plane's small dict
messages don't need.  numpy scalars serialize through a default hook
(the telemetry/ledger payloads carry ``np.int64``/``np.float64``).
``_encode`` gives the reference's bytes for every message.

Delivery is FIFO per direction (one TCP stream each way is one ordered
byte stream) and lossless until close, so the transport inherits the
same conformance battery as ``inproc``; EOF surfaces as
``CommClosedError``, matching the contract.  Composes under ``flaky``
(``get_transport("flaky", inner="tcp")``) for loss/latency injection on
a real socket.

The repair: on Python >= 3.12.1 ``asyncio.Server.wait_closed()`` waits
until every connection the server accepted is closed.  The reference's
``TCPListener.stop`` awaits it first and never closes the comms it
accepted, so a handler that returns (or blocks) without closing its comm
hangs ``stop()`` for ever.  Here the listener keeps every comm it
accepts, and ``stop()`` closes the server, cancels the handler tasks and
aborts those comms *before* it awaits ``wait_closed()``.
"""
from __future__ import annotations

import asyncio
import json
import struct
from typing import Dict, List, Optional

import numpy as np

from .transport import (Comm, CommClosedError, HandleComm, Listener,
                        Transport, register_transport)

_HOST = "127.0.0.1"
_LEN = struct.Struct(">I")        # 4-byte big-endian frame length
MAX_FRAME = 64 * 1024 * 1024      # sanity bound, not a protocol limit


def _default(o):
    """JSON hook for the numpy scalars control messages carry."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def _encode(msg: Dict) -> bytes:
    body = json.dumps(msg, default=_default).encode("utf-8")
    return _LEN.pack(len(body)) + body


class TCPComm(Comm):
    """One established stream pair (reader/writer) as a message channel."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, label: str):
        self._reader = reader
        self._writer = writer
        self.label = label
        self._closed = False
        self._peer_closed = False

    async def send(self, msg: Dict) -> None:
        if self.closed:
            raise CommClosedError(f"{self.label}: channel closed")
        try:
            self._writer.write(_encode(msg))
            await self._writer.drain()
        except (ConnectionError, RuntimeError) as e:
            self._peer_closed = True
            raise CommClosedError(f"{self.label}: {e}") from None

    async def _read_frame(self) -> Dict:
        try:
            head = await self._reader.readexactly(_LEN.size)
            (n,) = _LEN.unpack(head)
            if n > MAX_FRAME:
                raise CommClosedError(f"{self.label}: oversized frame "
                                      f"({n} bytes)")
            body = await self._reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError):
            self._peer_closed = True
            raise CommClosedError(f"{self.label}: peer closed") from None
        return json.loads(body.decode("utf-8"))

    async def recv(self, timeout: Optional[float] = None) -> Dict:
        if self._closed:
            raise CommClosedError(f"{self.label}: channel closed")
        if self._peer_closed:
            raise CommClosedError(f"{self.label}: peer closed")
        frame = self._read_frame()
        return await (asyncio.wait_for(frame, timeout)
                      if timeout is not None else frame)

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    def abort(self) -> None:
        """Drop the connection at once, unsent bytes included: a graceful
        close, or one still flushing, can wait for ever on a peer that
        does not read."""
        self._closed = True
        self._writer.transport.abort()

    @property
    def closed(self) -> bool:
        return self._closed or self._peer_closed


class TCPListener(Listener):
    def __init__(self, handle_comm: HandleComm, address: Optional[str]):
        self.address = address or f"tcp://{_HOST}:0"
        self._handle_comm = handle_comm
        self._server: Optional[asyncio.base_events.Server] = None
        self._tasks: List[asyncio.Task] = []
        self._comms: List[TCPComm] = []

    async def start(self) -> None:
        _, _, port = _split(self.address)
        self._server = await asyncio.start_server(self._accept, _HOST,
                                                  port)
        real = self._server.sockets[0].getsockname()[1]
        self.address = f"tcp://{_HOST}:{real}"

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        comm = TCPComm(reader, writer, f"{self.address}#server")
        self._comms.append(comm)
        self._tasks.append(asyncio.ensure_future(self._handle_comm(comm)))

    async def stop(self) -> None:
        """Stop accepting, end the handlers and drop the connections they
        left open, then wait for the server: ``wait_closed()`` returns
        only once every accepted connection is gone (Python >= 3.12.1)."""
        server, self._server = self._server, None
        if server is not None:
            server.close()
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        for comm in self._comms:
            comm.abort()        # a no-op on a connection already lost
        self._comms.clear()
        if server is not None:
            await server.wait_closed()


def _split(address: str):
    if not address.startswith("tcp://"):
        raise ValueError(f"not a tcp address: {address!r}")
    host, _, port = address[len("tcp://"):].rpartition(":")
    return address, host, int(port)


@register_transport("tcp")
class TCPTransport(Transport):
    """Localhost TCP with length-prefixed JSON frames."""

    def listen(self, handle_comm: HandleComm,
               address: Optional[str] = None) -> Listener:
        return TCPListener(handle_comm, address)

    async def connect(self, address: str) -> Comm:
        _, host, port = _split(address)
        try:
            reader, writer = await asyncio.open_connection(host, port)
        except ConnectionError as e:
            raise CommClosedError(f"no tcp listener at {address!r}: "
                                  f"{e}") from None
        return TCPComm(reader, writer, f"{address}#client")


__all__ = ["TCPComm", "TCPListener", "TCPTransport", "MAX_FRAME"]
