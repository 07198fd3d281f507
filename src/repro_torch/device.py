"""Device selection shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card
that default raises: the port never carries on quietly on the CPU.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA "
            f"device; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device; got {dev}")
    return dev
