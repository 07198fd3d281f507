"""One generic plugin registry behind every string-keyed surface.

The port's own copy of the reference ``repro.core.registry`` (the port
imports nothing of ``repro``): ``SCHEME_REGISTRY`` (policies) and
``SAMPLER_BACKENDS`` (draw engines) are thin instantiations with the
same ``register_*`` / ``get_*`` / ``list_*`` discipline and the same
fail-fast ``KeyError`` listing the registered keys.

A ``Registry`` is a read-only ``Mapping`` over its *canonical* entries,
so the usual idioms (``name in SCHEME_REGISTRY``, ``list(
SAMPLER_BACKENDS)``) work.  Aliases resolve in ``get`` but never appear
in the mapping view.
"""
from __future__ import annotations

from typing import Dict, Generic, Iterator, List, Mapping, Optional, \
    Sequence, TypeVar

T = TypeVar("T")


class Registry(Generic[T], Mapping[str, T]):
    """String-keyed plugin registry with uniform fail-fast errors.

    ``kind`` names the noun in error messages (``"scheme"``,
    ``"sampler backend"``, ...); ``dup_label`` overrides the noun in the
    duplicate-registration error only (the historical schemes message
    says "scheme name ... already registered").

    Unknown keys raise ``KeyError("unknown <kind> <name>; have [...]")``
    with the alias list appended when the registry has aliases --
    byte-identical to the reference registry's messages.
    """

    def __init__(self, kind: str, *, dup_label: Optional[str] = None):
        self.kind = kind
        self.dup_label = dup_label if dup_label is not None else kind
        self._entries: Dict[str, T] = {}
        self._aliases: Dict[str, str] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str, obj: T,
                 aliases: Sequence[str] = ()) -> T:
        """Key ``obj`` under ``name`` (+ aliases); duplicates fail fast."""
        for key in (name, *aliases):
            if key in self._entries or key in self._aliases:
                raise ValueError(f"{self.dup_label} {key!r} already "
                                 f"registered")
        self._entries[name] = obj
        for a in aliases:
            self._aliases[a] = name
        return obj

    # -- lookup -------------------------------------------------------------

    def canonical(self, name: str) -> str:
        """Resolve an alias to its canonical name (identity otherwise)."""
        return self._aliases.get(name, name)

    def get(self, name: str) -> T:  # type: ignore[override]
        """The registered object for ``name`` (alias-aware), or KeyError
        listing every registered key."""
        key = self._aliases.get(name, name)
        if key not in self._entries:
            raise KeyError(self.unknown_message(name))
        return self._entries[key]

    def unknown_message(self, name: str) -> str:
        msg = f"unknown {self.kind} {name!r}; have {self.names()}"
        if self._aliases:
            msg += f" (aliases: {sorted(self._aliases)})"
        return msg

    def names(self, include_aliases: bool = False) -> List[str]:
        names = sorted(self._entries)
        if include_aliases:
            names += sorted(self._aliases)
        return names

    def aliases(self) -> Dict[str, str]:
        return dict(self._aliases)

    # -- Mapping view over canonical entries --------------------------------

    def __getitem__(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(self.unknown_message(name))
        return self._entries[name]

    def __delitem__(self, name: str) -> None:
        """Unregister a canonical entry (tests use this for cleanup);
        aliases pointing at it are removed with it."""
        if name not in self._entries:
            raise KeyError(self.unknown_message(name))
        del self._entries[name]
        for a in [a for a, c in self._aliases.items() if c == name]:
            del self._aliases[a]

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: object) -> bool:
        return name in self._entries


__all__ = ["Registry"]
