"""Plain PyTorch version of flash attention (GQA, causal, sliding window).

The counterpart of ``repro.kernels.flash_attention.ref.attention_ref``:
the full (Sq, Sk) score matrix in float32, masked on right-aligned
positions (query i at position i + Sk - Sq), softmax, and rows that see
no key set to 0.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d); Hq % Hkv == 0."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)          # fully-masked rows
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return ctx.reshape(B, Sq, Hq, d).to(q.dtype)
