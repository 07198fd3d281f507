"""Arrival processes behind a small registry -- the demand axis.  The
port of ``repro.serving.arrivals``.

Exactly the ``SCHEME_REGISTRY`` / ``SCENARIO_REGISTRY`` pattern, applied
to *who sends jobs and when*:

    from repro_torch.serving import get_arrival, list_arrivals

    arr = get_arrival("poisson")                  # open-loop Poisson
    arr = get_arrival("trace", epochs=12)         # corpus-modulated
    arr = get_arrival("closed_loop", think_slots=4)

Every process is a frozen dataclass (a value -- all randomness flows
through the engine's rng) exposing ``job_counts(trials, slots,
jobs_per_slot, rng) -> (trials, slots) int64``, the number of jobs
offered per slot per trial.  ``jobs_per_slot`` is the *mean* demand the
engine derives from the swept offered load; open-loop processes modulate
it, the closed-loop process ignores it (demand comes from a finite
client population instead -- the engine reads ``closed_loop`` /
``population_for`` / ``think_slots`` and drives resubmission itself).

``trace`` reuses the measured-trace corpora of ``repro_torch.scenarios.traces``
as *demand* profiles: the corpus' per-epoch mean rate across workers,
normalized to mean 1 and stretched over the slot horizon, multiplies the
Poisson intensity -- measured diurnal burstiness for free, keyed by the
immutable corpus name (so it hashes like the ``trace_corpus`` scenario
family does).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Type

import numpy as np

from ..core.registry import Registry

ARRIVAL_REGISTRY: Registry[Type["ArrivalProcess"]] = \
    Registry("arrival process")


def register_arrival(name: str):
    """Class decorator: key an ArrivalProcess subclass under ``name``."""
    def deco(cls: Type["ArrivalProcess"]) -> Type["ArrivalProcess"]:
        ARRIVAL_REGISTRY.register(name, cls)
        cls.name = name
        return cls
    return deco


def list_arrivals() -> List[str]:
    return ARRIVAL_REGISTRY.names()


def get_arrival(name: str, **params) -> "ArrivalProcess":
    """Instantiate a registered arrival process; unknown names or params
    fail loudly (the ``validate_backend`` discipline)."""
    cls = ARRIVAL_REGISTRY.get(name)
    try:
        return cls(**params)
    except TypeError:
        allowed = [f.name for f in dataclasses.fields(cls)]
        raise KeyError(f"bad params {sorted(params)} for arrival process "
                       f"{name!r}; allowed {allowed}") from None


class ArrivalProcess:
    """Common surface of every arrival process (see module docstring)."""

    name: str = "abstract"
    closed_loop: bool = False

    def job_counts(self, trials: int, slots: int, jobs_per_slot: float,
                   rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


@register_arrival("poisson")
@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Open-loop memoryless stream: ``Poisson(jobs_per_slot)`` per slot."""

    def job_counts(self, trials, slots, jobs_per_slot, rng):
        return rng.poisson(jobs_per_slot, size=(trials, slots))


@register_arrival("trace")
@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Poisson stream whose intensity follows a measured-trace corpus.

    The demand profile is the corpus' per-epoch mean rate over all
    workers (epochs ``epoch_start .. epoch_start + epochs``, wrapping),
    normalized to mean 1 so the swept offered load stays the *average*
    load; epochs are stretched uniformly over the slot horizon.
    """

    corpus: Optional[str] = None        # None -> the committed default
    epoch_start: int = 0
    epochs: Optional[int] = None

    def profile(self, slots: int) -> np.ndarray:
        """(slots,) intensity multipliers, mean exactly 1."""
        from ..scenarios.traces import DEFAULT_CORPUS, load_corpus
        corpus = load_corpus(self.corpus or DEFAULT_CORPUS)
        window = corpus.window(corpus.workers, 0, int(self.epoch_start),
                               self.epochs)
        per_epoch = window.mean(axis=0)              # (E,) mean rate
        prof = per_epoch / per_epoch.mean()
        E = prof.size
        rows = np.minimum(np.arange(slots) * E // max(slots, 1), E - 1)
        stretched = prof[rows]
        return stretched / stretched.mean()

    def job_counts(self, trials, slots, jobs_per_slot, rng):
        lam = jobs_per_slot * self.profile(slots)
        return rng.poisson(np.broadcast_to(lam, (trials, slots)))


@register_arrival("burst")
@dataclasses.dataclass(frozen=True)
class BurstArrivals(ArrivalProcess):
    """Open-loop burst-then-idle stream: the whole offered demand lands
    in the first ``burst_frac`` of the horizon (intensity ``1 /
    burst_frac`` there, silence after; mean exactly 1, so the swept load
    stays the average).  The adversarial shape for queue mechanics --
    occupancy spikes to the buffer cap then drains to nothing, which is
    exactly what the engine's ``q_hi`` compaction regression test
    needs."""

    burst_frac: float = 0.1

    def __post_init__(self):
        if not 0.0 < float(self.burst_frac) <= 1.0:
            raise ValueError("burst_frac must be in (0, 1]")

    def job_counts(self, trials, slots, jobs_per_slot, rng):
        cut = max(1, int(round(float(self.burst_frac) * slots)))
        lam = np.zeros(slots, dtype=np.float64)
        lam[:cut] = jobs_per_slot * slots / cut
        return rng.poisson(np.broadcast_to(lam, (trials, slots)))


@register_arrival("closed_loop")
@dataclasses.dataclass(frozen=True)
class ClosedLoopArrivals(ArrivalProcess):
    """Finite client population with think time (interactive workload).

    Each client submits one job, thinks ``think_slots`` slots after the
    job completes, then resubmits -- the engine drives the resubmission
    loop.  ``population=None`` derives the population from the swept
    load knob as ``max(1, round(load * K))`` clients (load = clients
    per worker), so load sweeps stay meaningful in closed loop.
    """

    closed_loop = True
    population: Optional[int] = None
    think_slots: int = 0

    def __post_init__(self):
        if self.population is not None and int(self.population) < 1:
            raise ValueError("closed_loop population must be >= 1")
        if int(self.think_slots) < 0:
            raise ValueError("think_slots must be >= 0")

    def population_for(self, load: float, K: int) -> int:
        if self.population is not None:
            return int(self.population)
        return max(1, int(round(load * K)))

    def job_counts(self, trials, slots, jobs_per_slot, rng):
        # demand is driven by the engine's resubmission loop, not a
        # precomputed stream
        return np.zeros((trials, slots), dtype=np.int64)


__all__ = [
    "ARRIVAL_REGISTRY", "ArrivalProcess", "register_arrival", "get_arrival",
    "list_arrivals", "PoissonArrivals", "TraceArrivals", "BurstArrivals",
    "ClosedLoopArrivals",
]
