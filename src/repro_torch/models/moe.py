"""Mixture-of-Experts FFN with top-k routing and capacity-bounded
dispatch: the port of ``repro.models.moe`` for one device.

Dispatch is sort-based, as in the JAX package: each token's (token,
expert) pairs are ranked within their expert by a stable sort, the first
C of each expert get a slot in an (E, C, D) buffer and the rest are
dropped, the SwiGLU expert FFN runs batched over experts, and the outputs
are gathered back and summed with the renormalised router weights.

The three batched expert products go through the ``expert_matmul`` op:
the hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor.  (The JAX package computes them with einsum; the math is the
same.)  Kept slots are unique, so the JAX ``.at[slot].add(src)`` becomes
one ``index_copy_`` of every (token, k) row: kept rows land in their own
slot and dropped rows all in the trash row ``E*C``, which is cut off.
Which dropped row the trash row ends up holding is unspecified and never
read; there is no sum of rows, so bf16 rows are not added in an
unspecified order, and no host sync picks the kept rows out.

The backward matches the JAX package's (held against ``jax.grad``, with
pairs dropped, by ``tests/test_torch_train_moe.py``): ``index_copy_``'s
gradient reads each pair's slot row back, so a dropped pair (whose row
went to the cut-off trash row) gets exactly zero; the combine's gather
under ``torch.where`` adds exact zeros for dropped pairs; the router's
aux loss reaches the router only through ``probs``.  The JAX package
points every dropped pair's gather at row ``E*C-1``; where autograd
records the gather, each reads the row of its own index mod ``E*C``
instead, because the gather's sort-based backward on the card walks one
row's entries one after another: with half the pairs dropped, one shared
row took ~22 ms a layer (granite at 1 x 4096 tokens on an H100).  A
row's gradient is still at most one pair's cotangent plus exact zeros,
the same bits.  Without a backward (serving) the gather keeps the
reference's one clamp, which costs two kernels a layer fewer than the
spread: ~2 ms of a ~60 ms granite decode step on an H100.

The expert-parallel ``moe_apply_a2a`` needs a multi-device mesh and comes
with the mesh slice of the port.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm.ops import expert_matmul
from .common import Params, dense_init, randn


def moe_init(gen: torch.Generator, cfg, dtype, device: torch.device
             ) -> Params:
    """The router in float32, the experts' SwiGLU weights in ``dtype``,
    with the JAX package's scales."""
    D, Ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, D, E, torch.float32, device),
        "wi_gate": randn(gen, (E, D, Ff), device, dtype, D ** -0.5),
        "wi_up": randn(gen, (E, D, Ff), device, dtype, D ** -0.5),
        "wo": randn(gen, (E, Ff, D), device, dtype, Ff ** -0.5),
    }


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8


def _router(p: Params, cfg, xf: torch.Tensor):
    """float32 router over xf (T, D): returns (top_p (T, K) renormalised,
    top_e (T, K), the Switch load-balancing aux loss)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = xf.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)              # (T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(0)                                       # (E,)
    ce = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    return top_p, top_e, aux


def route(p: Params, cfg, x: torch.Tensor):
    """Routing and slotting of x (B, S, D).  Returns ``(top_p (T, K),
    slot (T*K,), keep (T*K,), C, aux)``: the (token, k) pair i goes to
    row ``slot[i]`` of the flattened (E*C, D) buffer when ``keep[i]``, and
    to the trash row E*C when its expert is already full."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    C = _capacity(T, cfg)
    top_p, top_e, aux = _router(p, cfg, x.reshape(T, D))
    # rank of each (token, k) within its expert, in token order
    flat_e = top_e.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_e, stable=True)               # by expert
    sorted_e = flat_e[order]
    # where each expert's segment starts: the JAX package's exclusive
    # cumsum of the bincount, found without the host sync that a CUDA
    # bincount makes to size its output
    seg_starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=x.device, dtype=sorted_e.dtype))
    ranks_sorted = torch.arange(T * K, device=x.device) - seg_starts[sorted_e]
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    keep = ranks < C                                         # overflow drops
    slot = torch.where(keep, flat_e * C + ranks, E * C)      # trash row
    return top_p, slot, keep, C, aux


def moe_apply_scatter(p: Params, cfg, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global sort + scatter dispatch.  x: (B, S, D) -> (out (B, S, D),
    aux loss scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    top_p, slot, keep, C, aux = route(p, cfg, x)
    xf = x.reshape(T, D)

    # dispatch: every (token, k) row to its slot, dropped ones to the trash
    src = xf.repeat_interleave(K, dim=0)                     # (T*K, D)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, src)
    buf = buf[: E * C].reshape(E, C, D)

    # expert FFN (SwiGLU), batched over experts
    gate = F.silu(expert_matmul(buf, p["wi_gate"]))
    up = expert_matmul(buf, p["wi_up"])
    out_buf = expert_matmul(gate * up, p["wo"])

    # combine: a dropped pair reads a row that the where() zeroes -- with
    # a backward, the row of its index mod E*C (see the module docstring)
    out_flat = out_buf.reshape(E * C, D)
    if out_buf.requires_grad:
        rows = torch.where(keep, slot,
                           torch.arange(T * K, device=x.device) % (E * C))
    else:
        rows = slot.clamp_max(E * C - 1)
    gathered = torch.where(keep[:, None], out_flat[rows], 0.0)
    weighted = gathered * top_p.reshape(-1, 1).to(x.dtype)
    out = weighted.reshape(T, K, D).sum(dim=1)
    return out.reshape(B, S, D), aux


def moe_apply(p: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).  On one device
    the JAX ``moe_apply`` takes the scatter path, and so does this."""
    return moe_apply_scatter(p, cfg, x)


def moe_apply_dense_ref(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """O(E * T) reference: every expert processes every token, masked by
    the top-k router weights.  It drops nothing, so it agrees with the
    dispatch path only where the capacity drops nothing."""
    B, S, D = x.shape
    E = cfg.n_experts
    xf = x.reshape(-1, D)
    top_p, top_e, _ = _router(p, cfg, xf)
    gate = F.silu(torch.einsum("td,edf->tef", xf, p["wi_gate"]))
    up = torch.einsum("td,edf->tef", xf, p["wi_up"])
    every = torch.einsum("tef,efd->ted", gate * up, p["wo"])   # (T, E, D)
    mask = torch.zeros((xf.shape[0], E), dtype=torch.float32,
                       device=x.device).scatter_add_(1, top_e, top_p)
    out = torch.einsum("ted,te->td", every, mask.to(x.dtype))
    return out.reshape(B, S, D)
