"""Streaming-arrival serving: the fourth subsystem.  The port of
``repro.serving``.

The paper's question is one batch of N units over K heterogeneous
workers; this package asks the production question behind it -- jobs
arrive continuously, what are p50/p99 latency, sustainable throughput,
and SLO-miss rate per scheme, per offered load?  (The regime of
Behrouzi-Far & Soljanin, arXiv:1808.02838, with HCMM-style loads from
arXiv:1701.05973 as one of the contenders.)

``ARRIVAL_REGISTRY`` says *who sends jobs and when*.  Every registered
scheme is recast as a dispatch policy (``repro_torch.serving.policies``)
and run through a queueing engine behind ``SERVING_BACKENDS``
(``repro_torch.serving.backends``): the slotted numpy loop
(``repro_torch.serving.engine``) is the exact conservation oracle on the
host, bit for bit the reference's; the ``torch`` backend
(``repro_torch.serving.scan``) runs the whole load sweep as one
slot-step loop of torch ops on a device, the card by default.
``repro_torch.serving.queueing`` holds the closed-form M/M/K results
both engines are validated against.

Wiring: attach ``ServingConfig`` to ``ExperimentSpec(serving=...)`` and
the ordinary ``run_experiment`` path -- compile, store, CLI -- sweeps
offered load instead of running single-batch MC.
"""
from .arrivals import (ARRIVAL_REGISTRY, ArrivalProcess, BurstArrivals,
                       ClosedLoopArrivals, PoissonArrivals, TraceArrivals,
                       get_arrival, list_arrivals, register_arrival)
from .backends import (SERVING_BACKENDS, SERVING_ENV, ServingBackend,
                       get_serving_backend, list_serving_backends,
                       register_serving_backend, resolve_serving_backend,
                       serving_backend_available)
from .config import AUTO_SLOTS_PER_JOB, ServingConfig
from .engine import run_serving_grid, simulate_serving
from .policies import (POLICY_ADAPTERS, DispatchPolicy, dispatch_policy,
                       lr_round_rows, register_policy)
from .queueing import erlang_b, erlang_c, mm1_sojourn, mmk_sojourn, mmk_wait

__all__ = [
    "ARRIVAL_REGISTRY", "ArrivalProcess", "PoissonArrivals",
    "TraceArrivals", "BurstArrivals", "ClosedLoopArrivals",
    "register_arrival", "get_arrival", "list_arrivals",
    "SERVING_BACKENDS", "SERVING_ENV", "ServingBackend",
    "register_serving_backend", "get_serving_backend",
    "list_serving_backends", "resolve_serving_backend",
    "serving_backend_available",
    "ServingConfig", "AUTO_SLOTS_PER_JOB",
    "simulate_serving", "run_serving_grid",
    "DispatchPolicy", "POLICY_ADAPTERS", "dispatch_policy",
    "register_policy", "lr_round_rows",
    "erlang_b", "erlang_c", "mmk_wait", "mmk_sojourn", "mm1_sojourn",
]
