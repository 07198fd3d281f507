"""PyTorch / CUDA port of the work-exchange reproduction.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Hand-written
CUDA kernels for Hopper (``sm_90a``) live in ``csrc/`` and are built at
first use.

    >>> from repro_torch.core import HetSpec, get_scheme
"""
from .core import HetSpec, get_scheme
from .device import resolve_device

__all__ = ["HetSpec", "get_scheme", "resolve_device"]
