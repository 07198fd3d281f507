"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427):
the port of ``repro.models.recurrent`` for serving and training.

Temporal mixing:  y = W_out( GeLU(W_gate x) * RGLRU(conv1d(W_in x)) )
RG-LRU cell:      r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
                  a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
                  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The prefill and training recurrence runs through the ``linear_scan``
op: the hand-written CUDA kernel on a CUDA tensor, its plain version on a
CPU tensor, forward and backward (a reverse scan on the same kernel).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.linear_scan.ops import linear_scan
from .common import Params, dense_init, gelu, randn

RGLRU_C = 8.0


def rglru_init(gen: torch.Generator, cfg, dtype, device: torch.device
               ) -> Params:
    D, R, W = cfg.d_model, cfg.lru_width, cfg.conv_width
    # Lambda so that a in [0.9, 0.999] at r=1 (Griffin appendix)
    if device.type == "meta":
        lam = torch.empty((R,), dtype=torch.float32, device=device)
    else:
        u = torch.empty((R,), dtype=torch.float32, device=device).uniform_(
            0.9 ** 2, 0.999 ** 2, generator=gen)
        lam = torch.log(torch.expm1(-torch.log(u) / (2 * RGLRU_C)))
    return {
        "w_in": dense_init(gen, D, R, dtype, device),
        "w_gate": dense_init(gen, D, R, dtype, device),
        "conv_w": randn(gen, (W, R), device, dtype, 1.0 / math.sqrt(W)),
        "w_a": dense_init(gen, R, R, dtype, device),
        "w_x": dense_init(gen, R, R, dtype, device),
        "lambda": lam,                       # (R,) fp32
        "w_out": dense_init(gen, R, D, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x: (B,S,R), w: (W,R).

    state: (B, W-1, R) previous inputs for decode; returns (y, new_state).
    """
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                    # (B, S+W-1, R)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(W - 1):] if W > 1 else torch.zeros_like(state)
    return y, new_state


def _rglru_coeffs(p: Params, cfg, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: conv output (B,S,R) -> per-step (a, b) of h = a*h + b, fp32."""
    r = torch.sigmoid((u @ p["w_a"]).float())
    i = torch.sigmoid((u @ p["w_x"]).float())
    log_a = -RGLRU_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u.float())
    return a, b


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (fp32), h_{-1} = 0, through
    the ``linear_scan`` op."""
    return linear_scan(a.contiguous(), b.contiguous())


def rglru_cache_init(cfg, batch: int, dtype, device: torch.device) -> Params:
    R, W = cfg.lru_width, cfg.conv_width
    return {"h": torch.zeros((batch, R), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, W - 1, R), dtype=dtype,
                                device=device)}


def _rglru_seq(p: Params, cfg, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The temporal-mix branch over a sequence, x: (B, S, D); returns the
    output, the conv input and the recurrence's states (fp32)."""
    u_in = x @ p["w_in"]
    u, _ = _causal_conv(u_in, p["conv_w"])
    a, b = _rglru_coeffs(p, cfg, u)
    hseq = linear_recurrence(a, b)
    gate = gelu(x @ p["w_gate"])
    return (gate * hseq.to(x.dtype)) @ p["w_out"], u_in, hseq


def rglru_forward(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full temporal-mix branch for training, x: (B, S, D); no state.
    Differentiable: the recurrence's backward is the reverse scan."""
    return _rglru_seq(p, cfg, x)[0]


def rglru_prefill(p: Params, cfg, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    """Temporal-mix branch over a prompt, x: (B, S, D); returns the output
    and the exact final state (h and the last W-1 conv inputs)."""
    y, u_in, hseq = _rglru_seq(p, cfg, x)
    W, S = cfg.conv_width, u_in.shape[1]
    conv_state = (u_in[:, S - (W - 1):] if S >= W - 1 else
                  F.pad(u_in, (0, 0, W - 1 - S, 0)))
    # copies, not views: a view would keep the whole (B, S, R) sequence
    # tensors of every layer alive in the cache
    return y, {"h": hseq[:, -1].clone(), "conv": conv_state.clone()}


def rglru_decode(p: Params, cfg, x: torch.Tensor, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """Single-step decode. x: (B, 1, D)."""
    u = x @ p["w_in"]
    u, conv_state = _causal_conv(u, p["conv_w"], cache["conv"])
    a, b = _rglru_coeffs(p, cfg, u)                     # (B,1,R)
    h = a[:, 0] * cache["h"] + b[:, 0]
    gate = gelu(x @ p["w_gate"])
    out = (gate * h[:, None].to(x.dtype)) @ p["w_out"]
    return out, {"h": h, "conv": conv_state}
