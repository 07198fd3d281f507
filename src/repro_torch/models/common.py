"""Shared model building blocks and the loss: plain functions on
tensors, with parameters in dicts laid out as in ``repro.models.common``
(``x @ W`` with ``W`` stored ``(in, out)``), so weights carry across as
copies.

Initial weights come from an explicit ``torch.Generator`` on the target
device.  Its numbers differ from ``jax.random``'s; tests carry the JAX
package's weights across with ``models.convert.params_from_jax``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def randn(gen: torch.Generator, shape, device: torch.device,
          dtype: torch.dtype, std: float) -> torch.Tensor:
    """``N(0, std^2)`` drawn in float32 from ``gen``, then cast: the JAX
    package's recipe.  On the ``meta`` device only the shape is made."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device: torch.device, scale: Optional[float] = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else in_dim ** -0.5
    return randn(gen, (in_dim, out_dim), device, dtype, scale)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device: torch.device) -> torch.Tensor:
    return randn(gen, (vocab, dim), device, dtype, 0.02)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * (1.0 + gamma.float()) + beta.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device = torch.device("cpu")) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                device: torch.device) -> Params:
    return {"wi_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "wi_up": dense_init(gen, d_model, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d_model, dtype, device)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ p["wi_gate"])
    return (gate * (x @ p["wi_up"])) @ p["wo"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  device: torch.device) -> Params:
    return {"wi": dense_init(gen, d_model, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d_model, dtype, device)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return gelu(x @ p["wi"]) @ p["wo"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Mean cross entropy in float32.

    The label's logit is read with a gather where the JAX package
    contracts with a one-hot (to keep a vocab-sharded axis sharded); on
    one device the two give the same float32 value.  The JAX function's
    optional weights and z-loss have no caller there and are left out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()
