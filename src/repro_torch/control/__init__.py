"""Live async control plane: execute work exchange over real transports.
The port of ``repro.control``; it imports torch and numpy only.

The paper's schemes are *planning* logic; this package is the runtime
that executes them.  An asyncio ``Coordinator`` drives K ``Worker``
tasks over a pluggable ``Transport`` (the fifth plugin surface,
``TRANSPORT_REGISTRY``): workers run real matmul shards on a torch
device, paced by their Exp(1/lambda_k) service clocks, the coordinator
takes every exchange decision by calling the existing registry schemes'
``make_scheduler``/``plan``, and each episode emits a structured
telemetry timeline plus a measured-vs-predicted ``T_comp`` record.

    from repro_torch.control import LiveConfig, run_live

    rep = run_live("work_exchange", {}, het, N=2000,
                   cfg=LiveConfig(), trials=4)      # on the card
    rep = run_live(..., device="cpu")               # or on the CPU
    rep.t_comp                         # measured, model seconds
    rep.extra["control_plane"]         # timeline, ledger, overhead

or, through the declarative API:

    ExperimentSpec(..., execution="live", live=LiveConfig())
"""
from . import transport
from .transport import (Comm, CommClosedError, HandleComm, Listener,
                        Transport, TRANSPORT_REGISTRY, get_transport,
                        list_transports, register_transport)
from . import inproc       # noqa: F401  (registers "inproc")
from . import faults       # noqa: F401  (registers "flaky")
from . import tcp          # noqa: F401  (registers "tcp")
from .inproc import InProcTransport
from .faults import FlakyTransport
from .tcp import TCPTransport
from .config import LiveConfig
from .compute import MatmulPayload
from .telemetry import Telemetry
from .worker import Worker
from .coordinator import (Coordinator, EpisodeStats, WorkerLost,
                          WorkerProxy, run_live, run_live_grid)

__all__ = [
    "Comm", "CommClosedError", "HandleComm", "Listener", "Transport",
    "TRANSPORT_REGISTRY", "register_transport", "get_transport",
    "list_transports", "InProcTransport", "FlakyTransport",
    "TCPTransport", "LiveConfig",
    "MatmulPayload", "Telemetry", "Worker", "Coordinator", "EpisodeStats",
    "WorkerLost", "WorkerProxy", "run_live", "run_live_grid",
]
