"""Pluggable serving-engine backends (``SERVING_BACKENDS``).  The port of
``repro.serving.backends``.

The sampler-backend discipline (``repro_torch.core.samplers``) applied to
the queueing plane: the slotted numpy loop in ``engine.py`` stays the
exact int64-conservation oracle on the host, and the ``torch`` backend
(``repro_torch.serving.scan``) takes the role of the reference's ``jax``
``lax.scan``: one slot-step loop of torch ops on a device with the
``loads`` sweep batched as extra trial-block rows -- one dispatch per
(policy, schedule) cell produces the whole load-vs-latency curve.  The
reference's ``jax`` name is not registered: a config naming it raises
the registry's ``KeyError``.

A backend's unit of work is the *sweep*: every load of one
``(het, scheme, rate_schedule)`` cell, returning one ``MCReport`` per
load in ``cfg.loads`` order.  The numpy sweep reproduces the historical
``run_serving_grid`` per-load loop bit-for-bit (``default_rng([seed, g,
load_index])`` per cell).

Resolution order is kwarg > ``$REPRO_SERVING_BACKEND`` > ``"numpy"``
(``resolve_serving_backend``); like the sampler knob, an explicit
``"numpy"`` is indistinguishable from the default and defers to the
environment.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List

from ..core.registry import Registry

__all__ = [
    "SERVING_BACKENDS", "SERVING_ENV", "ServingBackend",
    "register_serving_backend", "get_serving_backend",
    "list_serving_backends", "resolve_serving_backend",
    "serving_backend_available",
]

SERVING_ENV = "REPRO_SERVING_BACKEND"


@dataclass(frozen=True)
class ServingBackend:
    """One queueing engine: ``sweep(het, scheme_name, params, cfg, N,
    trials, seed, grid_index, rate_schedule, device)`` -> ``[MCReport]``,
    one per load in ``cfg.loads`` order.  ``shards`` marks engines that
    split the stacked (load x trial) rows over the devices of an active
    ``grid_sharding`` (so ``compile_plan`` may lift the serving
    ``devices=1`` pin)."""

    name: str
    sweep: Callable[..., List]
    description: str = ""
    shards: bool = False
    available: Callable[[], bool] = field(default=lambda: True, repr=False)


SERVING_BACKENDS: Registry[ServingBackend] = Registry("serving backend")


def register_serving_backend(backend: ServingBackend,
                             aliases=()) -> ServingBackend:
    return SERVING_BACKENDS.register(backend.name, backend, aliases=aliases)


def get_serving_backend(name: str) -> ServingBackend:
    return SERVING_BACKENDS.get(name)


def list_serving_backends() -> List[str]:
    return SERVING_BACKENDS.names()


def serving_backend_available(name: str) -> bool:
    return SERVING_BACKENDS.get(name).available()


def resolve_serving_backend(name: str = None) -> str:
    """Canonical backend name: kwarg > ``$REPRO_SERVING_BACKEND`` >
    ``"numpy"``.  An explicit ``"numpy"`` defers to the environment (the
    sampler-backend semantics: the default is a preference, not a pin).
    Unknown names raise ``KeyError`` listing the registry; registered but
    unavailable ones raise ``RuntimeError``."""
    if name is None or name == "numpy":
        name = os.environ.get(SERVING_ENV) or "numpy"
    backend = SERVING_BACKENDS.get(name)
    if not backend.available():
        raise RuntimeError(
            f"serving backend {backend.name!r} is registered but "
            f"unavailable on this host")
    return backend.name


# ---------------------------------------------------------------------------
# the two built-in engines
# ---------------------------------------------------------------------------

def _numpy_sweep(het, scheme_name, params, cfg, N, trials, seed,
                 grid_index, rate_schedule, device=None):
    """The historical ``run_serving_grid`` inner loop, verbatim: one
    ``simulate_serving`` call per load with its own
    ``default_rng([seed, g, li])`` stream -- the bit-exact oracle.  It
    runs on the host; ``device`` is not read."""
    import numpy as np

    from .engine import simulate_serving

    reports = []
    for li, load in enumerate(cfg.loads):
        rng = np.random.default_rng(
            [int(seed) & (2 ** 63 - 1), int(grid_index), li])
        reports.append(simulate_serving(
            het, scheme_name, params, cfg, N, float(load), trials, rng,
            rate_schedule=rate_schedule))
    return reports


def _torch_sweep(het, scheme_name, params, cfg, N, trials, seed,
                 grid_index, rate_schedule, device):
    from .scan import scan_sweep
    return scan_sweep(het, scheme_name, params, cfg, N, trials, seed,
                      grid_index, rate_schedule, device=device)


register_serving_backend(ServingBackend(
    name="numpy",
    sweep=_numpy_sweep,
    description="slotted numpy loop on the host; exact int64-conservation "
                "oracle"))

register_serving_backend(ServingBackend(
    name="torch",
    sweep=_torch_sweep,
    description="slot-step loop of torch ops on the device; loads batched "
                "as rows, shape-bucketed, rows split under grid_sharding",
    shards=True))
