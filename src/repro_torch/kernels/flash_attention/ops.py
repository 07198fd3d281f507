"""Dispatch for attention: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs the plain version.  Nothing falls back from one
to the other."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d). Returns (B, Sq, Hq, d)."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, window, scale)
    return attention_ref(q, k, v, causal, window, scale)
