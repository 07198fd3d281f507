"""Decoder-LM assembly for serving and training: the port of
``repro.models.transformer`` for the block kinds ``attn`` (with a dense
or an MoE FFN) and ``rec`` (RG-LRU).  Training (``lm_loss``) takes both
FFNs: an MoE layer's router aux loss is carried in float32 through the
stack, summed in layer order, and added to the loss with ``aux_weight``.

Layers are grouped into repeating "periods" (the block pattern of hybrid
archs; period 1 for homogeneous stacks).  Parameters keep the JAX
package's layout, so weights carry across leaf for leaf:
  params["body"] = {"b<i>": block-params stacked over n_periods}
  params["tail"] = {"t<i>": block-params}
PyTorch runs eagerly, so ``mode="scan"`` and ``"unroll"`` are the same
Python loop over the periods (indexing a stacked weight is a view).
Caches keep one buffer per layer (the JAX package's ``stacked=False``
serving layout): ``{"body": {"b<i>": [per-period cache]}, "tail":
{"t<i>": cache}, "pos": int}``.

MLA, xLSTM (mlstm / slstm) and the vision frontend come with later
slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec_mod
from .common import (Params, dense_init, dtype_of, embed_init, rmsnorm,
                     softmax_xent, swiglu, swiglu_init)

MODES = ("scan", "unroll")


# ---------------------------------------------------------------------------
# layer plan and what this slice serves
# ---------------------------------------------------------------------------

def layer_plan(cfg):
    kinds = cfg.layer_kinds()
    if cfg.block_pattern:
        p = len(cfg.block_pattern)
    elif cfg.slstm_every:
        p = cfg.slstm_every
    else:
        p = 1
    full = cfg.n_layers // p
    tail = kinds[full * p:]
    return kinds[:p], full, tail


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what a later slice ports."""
    later = []
    if cfg.attn_kind == "mla":
        later.append("MLA attention (the minicpm3 slice)")
    if cfg.slstm_every:
        later.append("mLSTM / sLSTM blocks (the xLSTM slice)")
    if cfg.frontend == "vision":
        later.append("the vision frontend (the internvl2 slice)")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: " + "; ".join(later) + " come with a later slice "
            "of the port; it serves GQA stacks (dense or MoE) and RG-LRU")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")


def _window(cfg) -> int:
    return cfg.window if cfg.attn_kind == "swa" or cfg.block_pattern else 0


# ---------------------------------------------------------------------------
# block init / apply by kind
# ---------------------------------------------------------------------------

def _block_init(gen, cfg, kind: str, dtype, device) -> Params:
    D = cfg.d_model
    zeros = dict(dtype=dtype, device=device)
    if kind == "attn":
        return {"ln1": torch.zeros((D,), **zeros),
                "attn": attn.gqa_init(gen, cfg, dtype, device),
                "ln2": torch.zeros((D,), **zeros),
                "mlp": (moe_mod.moe_init(gen, cfg, dtype, device)
                        if cfg.is_moe else
                        swiglu_init(gen, D, cfg.d_ff, dtype, device))}
    if kind == "rec":
        return {"ln1": torch.zeros((D,), **zeros),
                "rec": rec_mod.rglru_init(gen, cfg, dtype, device),
                "ln2": torch.zeros((D,), **zeros),
                "mlp": swiglu_init(gen, D, cfg.d_ff, dtype, device)}
    raise ValueError(kind)


def _block_cache_init(cfg, kind: str, batch: int, s_max: int, dtype,
                      device) -> Params:
    if kind == "attn":
        return attn.gqa_cache_init(cfg, batch, s_max, _window(cfg), dtype,
                                   device)
    if kind == "rec":
        return rec_mod.rglru_cache_init(cfg, batch, dtype, device)
    raise ValueError(kind)


def _ffn(p: Params, cfg, kind: str, x: torch.Tensor) -> torch.Tensor:
    """A block's FFN: the MoE for an ``attn`` block of an MoE config (its
    aux loss discarded at serving, as the JAX ``lm_prefill`` does), else a
    dense SwiGLU."""
    if kind == "attn" and cfg.is_moe:
        return moe_mod.moe_apply(p, cfg, x)[0]
    return swiglu(p, x)


def _block_prefill(p: Params, cfg, kind: str, h: torch.Tensor,
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, cache = attn.gqa_prefill(p["attn"], cfg, x, cache, _window(cfg))
    elif kind == "rec":
        y, cache = rec_mod.rglru_prefill(p["rec"], cfg, x)
    else:
        raise ValueError(kind)
    h = h + y
    return h + _ffn(p["mlp"], cfg, kind, rmsnorm(h, p["ln2"], cfg.norm_eps)), \
        cache


def _block_decode(p: Params, cfg, kind: str, h: torch.Tensor,
                  cache: Params, pos: int) -> Tuple[torch.Tensor, Params]:
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, cache = attn.gqa_decode(p["attn"], cfg, x, cache, pos,
                                   _window(cfg))
    elif kind == "rec":
        y, cache = rec_mod.rglru_decode(p["rec"], cfg, x, cache)
    else:
        raise ValueError(kind)
    h = h + y
    return h + _ffn(p["mlp"], cfg, kind, rmsnorm(h, p["ln2"], cfg.norm_eps)), \
        cache


def _block_fwd(p: Params, cfg, kind: str, h: torch.Tensor,
               aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / no-cache forward of one block: returns (h, aux), the
    MoE FFN of an ``attn`` block adding its router aux loss to the float32
    carry ``aux`` (as the JAX ``_block_fwd``)."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        h = h + attn.gqa_forward(p["attn"], cfg, x, _window(cfg))
    elif kind == "rec":
        h = h + rec_mod.rglru_forward(p["rec"], cfg, x)
    else:
        raise ValueError(kind)
    x = rmsnorm(h, p["ln2"], cfg.norm_eps)
    if kind == "attn" and cfg.is_moe:
        y, a = moe_mod.moe_apply(p["mlp"], cfg, x)
        return h + y, aux + a
    return h + swiglu(p["mlp"], x), aux


# ---------------------------------------------------------------------------
# full-model init
# ---------------------------------------------------------------------------

def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree: Any, j: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


def init_lm_params(cfg, gen: torch.Generator, device: torch.device
                   ) -> Params:
    """Random weights drawn from ``gen`` on ``device`` (``meta`` makes the
    shapes only), in the JAX package's layout and dtypes."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    period, full, tail = layer_plan(cfg)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dt, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_padded, dt,
                              device),
    }
    params["body"] = {
        f"b{i}": _stack([_block_init(gen, cfg, kind, dt, device)
                         for _ in range(full)])
        for i, kind in enumerate(period)}
    params["tail"] = {f"t{i}": _block_init(gen, cfg, kind, dt, device)
                      for i, kind in enumerate(tail)}
    return params


def init_cache(cfg, batch: int, s_max: int, device: torch.device) -> Params:
    check_supported(cfg)
    dt = dtype_of(cfg)
    period, full, tail = layer_plan(cfg)
    return {
        "body": {f"b{i}": [_block_cache_init(cfg, kind, batch, s_max, dt,
                                             device) for _ in range(full)]
                 for i, kind in enumerate(period)},
        "tail": {f"t{i}": _block_cache_init(cfg, kind, batch, s_max, dt,
                                            device)
                 for i, kind in enumerate(tail)},
        "pos": 0}


# ---------------------------------------------------------------------------
# stack execution
# ---------------------------------------------------------------------------

def _run_stack(params: Params, cfg, h: torch.Tensor, cache: Params,
               step) -> Tuple[torch.Tensor, Params]:
    """Apply ``step(p, kind, h, layer_cache) -> (h, layer_cache)`` over
    the body periods, then the tail; returns h and the new caches."""
    period, full, tail = layer_plan(cfg)
    body: Dict[str, List[Params]] = {f"b{i}": [] for i in range(len(period))}
    for j in range(full):
        for i, kind in enumerate(period):
            key = f"b{i}"
            h, c = step(_index(params["body"][key], j), kind, h,
                        cache["body"][key][j])
            body[key].append(c)
    tail_c = {}
    for i, kind in enumerate(tail):
        key = f"t{i}"
        h, tail_c[key] = step(params["tail"][key], kind, h,
                              cache["tail"][key])
    return h, {"body": body, "tail": tail_c}


def _unbind(tree: Any, n: int) -> List[Any]:
    """The ``n`` period slices of a stacked parameter tree, as views; the
    backward of ``unbind`` stacks their gradients once per leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(n)]
    return list(torch.unbind(tree))


def forward_hidden(params: Params, cfg, h: torch.Tensor,
                   mode: str = "scan", remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the full block stack for training; returns (h, moe_aux), the
    float32 sum of the MoE layers' aux losses in layer order (0 for a
    dense stack).

    ``remat`` recomputes each body period ("superblock") in the backward
    instead of keeping its activations (``torch.utils.checkpoint``, the
    counterpart of ``jax.checkpoint`` around the scanned superblock); the
    aux carry passes through it with h.  The tail stays outside it, as in
    the JAX package."""
    _check_mode(mode)
    period, full, tail = layer_plan(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def superblock(h, aux, pslice):
        for i, kind in enumerate(period):
            h, aux = _block_fwd(pslice[f"b{i}"], cfg, kind, h, aux)
        return h, aux

    for pslice in _unbind(params["body"], full):
        h, aux = (checkpoint(superblock, h, aux, pslice, use_reentrant=False)
                  if remat else superblock(h, aux, pslice))
    for i, kind in enumerate(tail):
        h, aux = _block_fwd(params["tail"][f"t{i}"], cfg, kind, h, aux)
    return h, aux


def lm_loss(params: Params, cfg, batch, mode: str = "scan",
            remat: bool = False, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S), plus ``aux_weight`` times the router aux
    sum for an MoE config; returns (loss, {"xent", "moe_aux"}), the JAX
    package's metrics.

    As in the JAX ``lm_loss``, ``"xent"`` is the loss after the aux term
    is added (the reference rebinds ``loss`` before it builds the
    metrics); the port keeps that, so the metrics match."""
    check_supported(cfg)
    h, aux = forward_hidden(params, cfg, params["embed"][batch["tokens"]],
                            mode, remat)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, h @ params["lm_head"])
    loss = softmax_xent(logits, batch["labels"])
    if cfg.is_moe:
        loss = loss + aux_weight * aux
    return loss, {"xent": loss, "moe_aux": aux}


def _mask_padded_vocab(cfg, logits: torch.Tensor) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) \
        >= cfg.vocab_size
    return logits.masked_fill(pad, torch.finfo(logits.dtype).min)


def lm_prefill_hidden(params: Params, cfg, batch, cache: Params
                      ) -> Tuple[torch.Tensor, Params]:
    """Prefill the stack over ``batch["tokens"]`` (B, S): returns the
    final-normed hidden states of every position (B, S, D) and the
    populated cache."""
    check_supported(cfg)
    h = params["embed"][batch["tokens"]]

    def step(p, kind, h, c):
        return _block_prefill(p, cfg, kind, h, c)

    h, new_cache = _run_stack(params, cfg, h, cache, step)
    new_cache["pos"] = h.shape[1]
    return rmsnorm(h, params["final_norm"], cfg.norm_eps), new_cache


def lm_prefill(params: Params, cfg, batch, cache: Params,
               mode: str = "unroll") -> Tuple[torch.Tensor, Params]:
    """Prefill: returns (last-position logits (B, 1, V), populated
    cache)."""
    _check_mode(mode)
    h, cache = lm_prefill_hidden(params, cfg, batch, cache)
    return _mask_padded_vocab(cfg, h[:, -1:] @ params["lm_head"]), cache


def lm_decode_step(params: Params, cfg, cache: Params, tokens: torch.Tensor,
                   mode: str = "unroll") -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1). Returns (logits, cache)."""
    _check_mode(mode)
    check_supported(cfg)
    pos = cache["pos"]
    h = params["embed"][tokens]

    def step(p, kind, h, c):
        return _block_decode(p, cfg, kind, h, c, pos)

    h, new_cache = _run_stack(params, cfg, h, cache, step)
    new_cache["pos"] = pos + 1
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _mask_padded_vocab(cfg, h @ params["lm_head"]), new_cache
