"""Pluggable async transports: the control plane's comm layer.  The
port's own copy of ``repro.control.transport``.

The connector/listener split mirrors dask.distributed's ``comm/core.py``:
a ``Transport`` (the fifth plugin surface, registered in
``TRANSPORT_REGISTRY`` with the same ``register_*``/``get_*``/``list_*``
discipline as schemes/samplers/scenarios/arrivals) builds ``Listener``s
on the serving side and ``Comm``s on the connecting side; an established
``Comm`` is a bidirectional ordered message channel.

    from repro_torch.control import get_transport

    transport = get_transport("inproc")
    listener = transport.listen(handle_comm)    # server side
    await listener.start()
    comm = await transport.connect(listener.address)
    await comm.send({"type": "hello"})

Registered transports:

``inproc``
    In-process asyncio queue pairs (``repro_torch.control.inproc``), the
    reference transport every conformance test runs against.
``flaky`` (alias ``faulty``)
    A fault-injection wrapper around any inner transport
    (``repro_torch.control.faults``): per-message latency/jitter and
    seeded random drops, for exercising the coordinator's timeout/retry
    path and worker-loss degradation.
``tcp``
    Localhost TCP streams with length-prefixed JSON frames
    (``repro_torch.control.tcp``).

Messages are plain dicts; in-process transports pass them by reference,
so senders must not mutate a message after ``send`` (the coordinator and
worker never do).
"""
from __future__ import annotations

import inspect
from typing import Awaitable, Callable, Dict, List, Optional, Sequence, Type

from ..core.registry import Registry


class CommClosedError(ConnectionError):
    """The peer closed the channel (or the address is not listening)."""


class Comm:
    """One established bidirectional message channel."""

    async def send(self, msg: Dict) -> None:
        raise NotImplementedError

    async def recv(self, timeout: Optional[float] = None) -> Dict:
        """Next message in send order.  Raises ``asyncio.TimeoutError``
        when ``timeout`` (seconds) elapses with nothing to deliver, and
        ``CommClosedError`` once the peer has closed."""
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError


# the server-side accept callback: one task per accepted comm
HandleComm = Callable[[Comm], Awaitable[None]]


class Listener:
    """A serving endpoint bound to ``address``."""

    address: str

    async def start(self) -> None:
        raise NotImplementedError

    async def stop(self) -> None:
        raise NotImplementedError


class Transport:
    """Connector/listener factory for one wire protocol."""

    name: str = "abstract"

    def listen(self, handle_comm: HandleComm,
               address: Optional[str] = None) -> Listener:
        raise NotImplementedError

    async def connect(self, address: str) -> Comm:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# registry (the fifth plugin surface, on the port's core Registry)
# ---------------------------------------------------------------------------

TRANSPORT_REGISTRY: Registry[Type[Transport]] = Registry("transport")


def register_transport(name: str, *, aliases: Sequence[str] = ()):
    """Class decorator: key a Transport subclass under ``name``."""
    def deco(cls: Type[Transport]) -> Type[Transport]:
        TRANSPORT_REGISTRY.register(name, cls, aliases=aliases)
        cls.name = name
        return cls
    return deco


def get_transport(name: str, **params) -> Transport:
    """Instantiate a registered transport; unknown names or params fail
    loudly (the ``validate_backend`` discipline)."""
    cls = TRANSPORT_REGISTRY.get(name)
    try:
        return cls(**params)
    except TypeError:
        allowed = [p for p in inspect.signature(cls).parameters
                   if p != "self"]
        raise KeyError(f"bad params {sorted(params)} for transport "
                       f"{name!r}; allowed {allowed}") from None


def list_transports(include_aliases: bool = False) -> List[str]:
    return TRANSPORT_REGISTRY.names(include_aliases)


__all__ = [
    "CommClosedError", "Comm", "HandleComm", "Listener", "Transport",
    "TRANSPORT_REGISTRY", "register_transport", "get_transport",
    "list_transports",
]
