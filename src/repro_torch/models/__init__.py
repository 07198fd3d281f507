"""Model zoo of the port: blocks, the decoder stack, and the facade."""
from .registry import Model, build_model

__all__ = ["Model", "build_model"]
