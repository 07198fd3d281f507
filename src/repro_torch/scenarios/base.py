"""Scenario-family protocol + registry: the scenario axis as a plugin
(the port of ``repro.scenarios.base``).

A *scenario family* answers "which heterogeneity situations does this
experiment sweep?"  Each family is a frozen dataclass -- a pure value
with pinned seeds -- that materializes into ``HetSpec`` rows, exactly
like ``SCHEME_REGISTRY`` keys policies and ``SAMPLER_BACKENDS`` keys
draw pipelines:

    from repro_torch.scenarios import get_family, list_families

    fam = get_family("drifting")(K=50, points=[(50.0, 50.0**2 / 6, 1)])
    fam.specs()            # nominal HetSpec per grid point
    fam.rate_schedules()   # (G, R, K) per-round service rates, or None

Contract (enforced by ``tests/test_scenarios.py`` over every registered
family of the reference, and held for the port's by
``tests/test_torch_scenarios.py``):

* ``specs()`` is deterministic -- every random choice is pinned by a
  seed field, so the family is a value, not a process;
* ``to_dict`` / ``from_dict`` round-trip losslessly, and every knob that
  changes ``specs()`` or ``rate_schedules()`` appears in ``to_dict()``
  (the dict is the family's ``spec_hash`` contribution);
* ``from_dict`` is strict: unknown keys raise ``KeyError`` naming the
  allowed knobs and the registered families (the ``validate_backend``
  behaviour -- typos fail loudly, never silently);
* ``rate_schedules()`` returns the optional ``(G, R, K)`` per-exchange-
  round service-rate schedule (drifting / trace-corpus families); the
  engines hold row ``R - 1`` for rounds beyond the schedule.

Serialization back-compat: the two PR-4 families serialize WITHOUT a
``family`` key (``uniform_random`` -> ``{"K", "points"}``, ``explicit``
-> ``{"explicit"}``) so every pre-existing spec hash and store address
survives the refactor; new families carry ``{"family": <name>, ...}``.
``scenario_from_dict`` dispatches both shapes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Type

import numpy as np

from ..core.registry import Registry
from ..core.types import HetSpec

SCENARIO_REGISTRY: Registry[Type["ScenarioFamily"]] = \
    Registry("scenario family")


def register_family(name: str):
    """Class decorator: key a ScenarioFamily subclass under ``name``."""
    def deco(cls: Type["ScenarioFamily"]) -> Type["ScenarioFamily"]:
        SCENARIO_REGISTRY.register(name, cls)
        cls.family = name
        return cls
    return deco


def list_families() -> List[str]:
    return SCENARIO_REGISTRY.names()


def get_family(name: str) -> Type["ScenarioFamily"]:
    return SCENARIO_REGISTRY.get(name)


class ScenarioFamily:
    """Common surface of every scenario family (see module docstring)."""

    family: str = "abstract"

    # -- materialization ----------------------------------------------------

    def specs(self) -> List[HetSpec]:
        """One nominal ``HetSpec`` per grid point, point order preserved."""
        raise NotImplementedError

    def rate_schedules(self) -> Optional[np.ndarray]:
        """Optional ``(G, R, K)`` per-exchange-round service rates.

        ``None`` (the default) means the scenario is stationary: the
        nominal rates hold for the whole run.  Families that drift
        return one ``(R, K)`` schedule per grid point; round ``r >= R``
        holds the last row.  Schedules are consumed by schemes with
        ``supports_rate_schedule`` (the work-exchange variants); single
        -shot schemes run at the nominal (round-0) rates.
        """
        return None

    def __len__(self) -> int:
        return len(self.specs())

    # subclasses also expose ``K`` (the shared worker count) -- as a
    # dataclass field or a property; the base deliberately defines no
    # default so dataclass subclasses don't inherit one

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScenarioFamily":
        raise NotImplementedError


def check_keys(d: Mapping[str, Any], required: frozenset,
               optional: frozenset, family: str) -> None:
    """Strict key validation for family ``from_dict``s: unknown keys
    raise ``KeyError`` listing the family's knobs AND the registered
    families, missing required keys raise ``KeyError`` as well."""
    keys = set(d)
    unknown = keys - required - optional - {"family"}
    if unknown:
        raise KeyError(
            f"unknown scenario key(s) {sorted(unknown)} for family "
            f"{family!r}; allowed {sorted(required | optional)} "
            f"(registered families: {list_families()})")
    missing = required - keys
    if missing:
        raise KeyError(f"scenario family {family!r} is missing required "
                       f"key(s) {sorted(missing)}")


def scenario_from_dict(d: Mapping[str, Any]) -> ScenarioFamily:
    """Deserialize any registered family (legacy PR-4 shapes included).

    Dispatch: an explicit ``family`` key wins; the key-less PR-4 shapes
    ``{"K", "points"}`` and ``{"explicit"}`` route to ``uniform_random``
    / ``explicit`` (the compatibility shim that keeps every pre-refactor
    spec hash addressable).  Anything else -- an unknown family name, or
    extra keys tacked onto a legacy shape -- raises ``KeyError`` listing
    the registered families.
    """
    if not isinstance(d, Mapping):
        raise KeyError(f"scenario grid must be a mapping; got "
                       f"{type(d).__name__} (registered families: "
                       f"{list_families()})")
    if "family" in d:
        return get_family(d["family"]).from_dict(d)
    if "explicit" in d:
        return get_family("explicit").from_dict(d)
    if "points" in d:
        return get_family("uniform_random").from_dict(d)
    raise KeyError(
        f"scenario grid dict has no 'family' key and no legacy "
        f"'points'/'explicit' shape (got keys {sorted(d)}); registered "
        f"families: {list_families()}")


__all__ = [
    "SCENARIO_REGISTRY", "ScenarioFamily", "register_family", "get_family",
    "list_families", "scenario_from_dict", "check_keys",
]
