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

On a mesh (``distributed.sharding.use_mesh``) every function takes this
rank's local tensors and its weights gathered over 'data' (the serving
layout; training gathers its FSDP blocks before the block runs,
``models.transformer._gathered``).  ``moe_apply`` dispatches as the JAX
package's does: the expert-parallel ``moe_apply_a2a`` when the mesh's
``model`` axis has more than one rank and the sequence (S > 1) splits
over it, else the scatter path.  ``moe_apply_a2a`` is the JAX package's
``shard_map`` body run eagerly on each rank's (batch over the batch axes,
sequence over ``model``) token block: local routing and capacity
(``c_send``), one ``all_to_all`` there and one back over ``model``
(``collectives.exchange``: its backward is the same exchange), the
rank's E/tp experts (padded to ``E_pad`` with dummy experts behind
``-1e30`` logits where tp does not divide E, their weights gathered over
``model`` with a reduce-scatter backward), and the aux term's mean over
every axis (``collectives.mean_over_all``).  Its per-rank capacity drops
other pairs than the global scatter: it is a different computation
wherever pairs drop, as in the JAX package.  On a mesh the scatter path
gathers every token (over the batch axes, and the sequence over
``model`` where it is split; the gather's backward reduce-scatters) and
routes and slots them as on one device.  Where ``model`` is 1 it splits
the buffer's capacity over the batch axes, the JAX package's
``maybe_shard(buf, ep, BATCH_AXES, None)``: each rank runs its C / n
block of every expert and ``out_buf`` is all-gathered (reduce-scattered
in the backward).  Where ``model`` > 1 (decode, S = 1; serving only) it
runs this rank's experts (``maybe_shard(buf, "model", ...)``; with tp
not dividing E, every expert on this rank's slice of F, summed over
``model``) and all-gathers the expert outputs, so each rank combines
exactly what one device would.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives as coll
from ..distributed.sharding import (BATCH_AXES, active_mesh, axis_index,
                                    axis_size, local_block, maybe_shard,
                                    resolve_spec, use_mesh)
from ..kernels.moe_gmm.ops import expert_matmul
from .common import Params, dense_init, randn

# Dispatch implementation: 'auto' takes the all-to-all expert-parallel
# path on a mesh whose 'model' axis splits the sequence (prefill), the
# scatter path otherwise (decode, one device); 'scatter' pins the latter.
MOE_IMPL = "auto"
ALL_AXES = ("pod", "data", "model")


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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as float32, by the same ops on every device
    (``F.one_hot`` checks its classes on the CPU, scatters on CUDA and
    compares on ``meta``, so a step's accounting would differ between
    the card and its dry run)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


def _router(p: Params, cfg, xf: torch.Tensor):
    """float32 router over xf (T, D): returns (top_p (T, K) renormalised,
    top_e (T, K), the Switch load-balancing aux loss)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = xf.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)              # (T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(0)                                       # (E,)
    ce = _one_hot(top_e[:, 0], E).mean(0)
    aux = E * torch.sum(me * ce)
    return top_p, top_e, aux


def _local_rank_in_expert(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each (token, k) entry within its expert, in entry order."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)               # by expert
    sorted_e = flat_e[order]
    # where each expert's segment starts: the JAX package's exclusive
    # cumsum of the bincount, found without the host sync that a CUDA
    # bincount makes to size its output
    seg_starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=flat_e.device, dtype=sorted_e.dtype))
    ranks_sorted = torch.arange(n, device=flat_e.device) - seg_starts[sorted_e]
    return torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)


def route(p: Params, cfg, x: torch.Tensor):
    """Routing and slotting of x (B, S, D).  Returns ``(top_p (T, K),
    slot (T*K,), keep (T*K,), C, aux)``: the (token, k) pair i goes to
    row ``slot[i]`` of the flattened (E*C, D) buffer when ``keep[i]``, and
    to the trash row E*C when its expert is already full."""
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    C = _capacity(T, cfg)
    top_p, top_e, aux = _router(p, cfg, x.reshape(T, D))
    flat_e = top_e.reshape(-1)                               # (T*K,)
    ranks = _local_rank_in_expert(flat_e, E)
    keep = ranks < C                                         # overflow drops
    slot = torch.where(keep, flat_e * C + ranks, E * C)      # trash row
    return top_p, slot, keep, C, aux


def _swiglu_experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wo: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert FFN batched over experts, buf (E, C, D)."""
    gate = F.silu(expert_matmul(buf, wg))
    up = expert_matmul(buf, wu)
    return expert_matmul(gate * up, wo)


def _expert_ffn(p: Params, cfg, buf: torch.Tensor) -> torch.Tensor:
    """The expert FFN of the whole (E, C, D) buffer, which every rank of a
    mesh holds alike.  Where 'model' is 1: this rank's block of the
    capacity over the batch axes (where they divide C), the outputs
    all-gathered.  Else the rank's E/tp experts, their outputs
    all-gathered over 'model'; where tp does not divide E, every expert on
    this rank's slice of F, the output's partial sums reduced over
    'model' (serving only)."""
    tp = axis_size("model")
    if tp > 1 and torch.is_grad_enabled() and any(
            t.requires_grad for t in (buf, p["wi_gate"], p["wi_up"], p["wo"])):
        raise NotImplementedError(
            f"the scatter path at model={tp} serves only; training takes "
            f"moe_apply_a2a, on a sequence that splits over model")
    if tp > 1 and cfg.n_experts % tp == 0:
        buf = maybe_shard(buf, "model", None, None)
        return coll.all_gather(_swiglu_experts(buf, p["wi_gate"], p["wi_up"],
                                               p["wo"]), "model", dim=0)
    if tp > 1:
        return coll.all_reduce(_swiglu_experts(
            buf, p["wi_gate"], p["wi_up"], p["wo"]), "model")
    spec = resolve_spec(buf.shape, (None, BATCH_AXES, None))
    out = _swiglu_experts(local_block(buf, spec).contiguous(), p["wi_gate"],
                          p["wi_up"], p["wo"])
    return out if spec[1] is None else coll.gather(out, spec[1], dim=1)


def _combine_rows(out_flat: torch.Tensor, slot: torch.Tensor,
                  keep: torch.Tensor) -> torch.Tensor:
    """The row of ``out_flat`` each pair's combine reads: its slot where
    kept; where dropped the last row (the JAX package's clamp) or, with a
    backward, the row of its index mod the rows (see the module
    docstring)."""
    n = out_flat.shape[0]
    if out_flat.requires_grad:
        return torch.where(keep, slot,
                           torch.arange(slot.shape[0], device=slot.device) % n)
    return slot.clamp_max(n - 1)


def moe_apply_scatter(p: Params, cfg, x: torch.Tensor,
                      seq_sharded: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global sort + scatter dispatch.  x: (B, S, D) -> (out (B, S, D),
    aux loss scalar).  On a mesh x is this rank's batch block (and, with
    ``seq_sharded``, its sequence block over 'model'): every token is
    gathered first, and this rank's block of the output returned."""
    on_mesh = active_mesh() is not None
    if on_mesh:
        if seq_sharded:
            x = coll.gather(x, "model", dim=1)
        x = coll.gather(x, BATCH_AXES, dim=0)
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
    out_buf = _expert_ffn(p, cfg, buf)

    # combine: a dropped pair reads a row that the where() zeroes
    out_flat = out_buf.reshape(E * C, D)
    gathered = torch.where(keep[:, None],
                           out_flat[_combine_rows(out_flat, slot, keep)], 0.0)
    weighted = gathered * top_p.reshape(-1, 1).to(x.dtype)
    out = weighted.reshape(T, K, D).sum(dim=1).reshape(B, S, D)
    if on_mesh:
        out = maybe_shard(out, BATCH_AXES, "model" if seq_sharded else None,
                          None)
    return out, aux


def route_local(p: Params, cfg, x: torch.Tensor):
    """The all-to-all path's routing of this rank's token block x (b, s,
    D): the router over E experts padded to ``E_pad`` (a multiple of the
    'model' axis) with ``-1e30`` logits, the aux term from the per-expert
    means averaged over every mesh axis, and slots under the local
    capacity ``c_send``.  Returns ``(top_p (t, K), slot (t*K,), keep
    (t*K,), c_send, E_pad, aux)``; pair i goes to row ``slot[i]`` of the
    (E_pad*c_send, D) send buffer when ``keep[i]``."""
    b, s, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    tp = axis_size("model")
    E_pad = -(-E // tp) * tp
    t = b * s
    logits = x.reshape(t, D).float() @ p["router"]           # (t, E)
    if E_pad > E:
        logits = F.pad(logits, (0, E_pad - E), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # globally exact load-balance loss: average the per-expert vectors
    # across shards BEFORE the product (== the unsharded computation)
    me = coll.mean_over_all(probs[:, :E].mean(0), ALL_AXES)
    ce = coll.all_reduce(_one_hot(top_e[:, 0], E_pad)[:, :E].mean(0),
                         ALL_AXES, "avg")
    aux = E * torch.sum(me * ce)
    c_send = max(4, -(-int(t * K * cfg.capacity_factor / E_pad) // 4) * 4)
    flat_e = top_e.reshape(-1)
    ranks = _local_rank_in_expert(flat_e, E_pad)
    keep = ranks < c_send
    slot = torch.where(keep, flat_e * c_send + ranks, E_pad * c_send)
    return top_p, slot, keep, c_send, E_pad, aux


def _a2a_experts(p: Params, cfg, E_pad: int):
    """This rank's E_pad/tp experts' weights: as they lie where tp divides
    E (sharded over 'model' by expert); else gathered over F, padded with
    zero (dummy) experts to E_pad and sliced by the rank's index."""
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    tp = axis_size("model")
    if cfg.n_experts % tp == 0:
        return wg, wu, wo
    E_loc = E_pad // tp
    lo = axis_index("model") * E_loc
    pad = (0, 0, 0, 0, 0, E_pad - cfg.n_experts)
    wg, wu = (F.pad(coll.gather(w, "model", dim=2), pad) for w in (wg, wu))
    wo = F.pad(coll.gather(wo, "model", dim=1), pad)
    return wg[lo:lo + E_loc], wu[lo:lo + E_loc], wo[lo:lo + E_loc]


def moe_apply_a2a(p: Params, cfg, x: torch.Tensor, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over 'model' with all-to-all, on this rank's
    token block x (b, s, D) (the batch over the data axes, the sequence
    over 'model') and its serving-layout weights: local routing and
    capacity, one exchange to the experts' ranks, the rank's experts on
    ``expert_matmul``, one exchange back.  Returns (out (b, s, D), aux),
    the JAX ``moe_apply_a2a``'s shard of each.  ``mesh`` defaults to the
    active one."""
    with use_mesh(active_mesh() if mesh is None else mesh):
        b, s, D = x.shape
        K = cfg.experts_per_token
        tp = axis_size("model")
        t = b * s
        top_p, slot, keep, c_send, E_pad, aux = route_local(p, cfg, x)
        E_loc = E_pad // tp
        src = x.reshape(t, D).repeat_interleave(K, dim=0)
        send = torch.zeros((E_pad * c_send + 1, D), dtype=x.dtype,
                           device=x.device)
        send.index_copy_(0, slot, src)
        send = send[:-1].reshape(tp, E_loc * c_send, D)
        recv = coll.exchange(send, "model")
        # recv[j] = my experts' tokens from model-peer j
        buf = recv.reshape(tp, E_loc, c_send, D).transpose(0, 1) \
            .reshape(E_loc, tp * c_send, D)
        out_buf = _swiglu_experts(buf, *_a2a_experts(p, cfg, E_pad))
        back = out_buf.reshape(E_loc, tp, c_send, D).transpose(0, 1) \
            .reshape(tp, E_loc * c_send, D)
        out_flat = coll.exchange(back, "model").reshape(E_pad * c_send, D)
        gathered = torch.where(keep[:, None],
                               out_flat[_combine_rows(out_flat, slot, keep)],
                               0.0)
        weighted = gathered * top_p.reshape(-1, 1).to(x.dtype)
        out = weighted.reshape(t, K, D).sum(dim=1)
        return out.reshape(b, s, D), aux


def math_prod(xs):
    """The product of ``xs``.  The JAX package's ``moe_apply_a2a`` keeps
    the batch whole (``batch_ok``) where the data axes' product does not
    divide it; the port shards it always, and ``train.serve``'s
    ``greedy_generate`` raises for such a batch."""
    out = 1
    for v in xs:
        out *= v
    return out


def moe_apply(p: Params, cfg, x: torch.Tensor, seq_sharded: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).  On a mesh x is
    this rank's block (``seq_sharded``: its sequence split over 'model');
    the all-to-all path runs where the JAX ``moe_apply`` takes it ('model'
    > 1, S % tp == 0, S > 1), else the scatter path."""
    tp = axis_size("model")
    S = x.shape[1] * (tp if seq_sharded else 1)
    if MOE_IMPL != "scatter" and tp > 1 and S % tp == 0 and S > 1:
        if seq_sharded:
            return moe_apply_a2a(p, cfg, x)
        out, aux = moe_apply_a2a(p, cfg, maybe_shard(x, None, "model", None))
        return coll.gather_replicated(out, "model", dim=1), aux
    return moe_apply_scatter(p, cfg, x, seq_sharded)


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
