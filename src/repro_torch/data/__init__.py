"""Synthetic training data of the port (numpy only), unit for unit the
JAX package's."""
from .pipeline import HetShardedLoader, UnitStore
from .synthetic import structured_unit, unit_tokens

__all__ = ["HetShardedLoader", "UnitStore", "structured_unit", "unit_tokens"]
