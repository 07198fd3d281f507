"""Decoder-LM assembly for serving and training: the port of
``repro.models.transformer`` for every block kind: ``attn`` (GQA with a
dense or an MoE FFN), ``mla`` (an ``attn`` layer of an MLA config),
``rec`` (RG-LRU), and the xLSTM's ``mlstm`` and ``slstm``; and the
vision frontend, whose projected image embeddings go in front of the
token embeddings (the loss is taken on the text positions).  Training
(``lm_loss``) carries an MoE layer's router aux loss in float32 through
the stack, summed in layer order, and adds it with ``aux_weight``.

Layers are grouped into repeating "periods" (the block pattern of hybrid
archs, the sLSTM period of xLSTM; period 1 for homogeneous stacks).
Parameters keep the JAX package's layout, so weights carry across leaf
for leaf:
  params["body"] = {"b<i>": block-params stacked over n_periods}
  params["tail"] = {"t<i>": block-params}
PyTorch runs eagerly, so ``mode="scan"`` and ``"unroll"`` are the same
Python loop over the periods (indexing a stacked weight is a view).
Caches keep one buffer per layer (the JAX package's ``stacked=False``
serving layout): ``{"body": {"b<i>": [per-period cache]}, "tail":
{"t<i>": cache}, "pos": int}``.

On a mesh (``distributed.sharding.use_mesh``) every function takes and
returns this rank's local tensors: serving in the JAX package's serving
layout (``param_specs(fsdp=False)``, ``cache_specs``, the batch over the
data axes), training (``lm_loss``) in its training layout
(``param_specs(fsdp=True)``: every weight's non-TP matrix dim over
``data``, FSDP).  Training gathers weights by their specs
(``_gathered``): each body period's inside its remat checkpoint, so one
period's whole weights live at a time and the backward gathers them
again, as the JAX package's full remat does; the tail blocks', the
embedding's, ``final_norm``'s and ``lm_head``'s where they are used.  The
gather's backward reduce-scatters each gradient over ``data``.  With
tensor parallelism (the ``model`` axis, tp > 1; the GQA and MoE
transformer only) the embedding is vocab-parallel (each rank looks up
the ids in its vocab rows, zeros the rest, and the ranks sum: exactly one
rank contributes each value), ``lm_head`` is split by vocab columns and
the logits gathered before ``_mask_padded_vocab``, and a sequence that
splits over ``model`` keeps the residual sequence-parallel
(``SEQ_SHARD_ACTIVATIONS``): attention and a dense FFN all-gather the
normed sequence first and reduce-scatter their output, the MoE's
all-to-all takes its token block as it lies.  Elsewhere (decode, a
sequence that does not split) the residual is whole on every rank of
``model`` and each partial output is all-reduced.  In training each
rank's work on its own heads or sequence block makes its gradient of a
weight that the ``model`` ranks hold alike (the norms, the router) a
partial sum: that weight's gather passes ``collectives.enter``, whose
backward sums it over ``model``; where the residual is whole, it enters
the norms through ``enter`` too, so the same holds there.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import collectives as coll
from ..distributed import sharding as shd
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec_mod
from . import xlstm as xlstm_mod
from .common import (Params, dense_init, dtype_of, embed_init, rmsnorm,
                     softmax_xent, swiglu, swiglu_init)

MODES = ("scan", "unroll")


# ---------------------------------------------------------------------------
# layer plan
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


def _resolve_kind(cfg, kind: str) -> str:
    if kind == "attn" and cfg.attn_kind == "mla":
        return "mla"
    return kind


def _period(cfg) -> Tuple[List[str], int, Tuple[str, ...]]:
    """``layer_plan`` with each kind resolved."""
    period, full, tail = layer_plan(cfg)
    return ([_resolve_kind(cfg, k) for k in period], full,
            tuple(_resolve_kind(cfg, k) for k in tail))


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
    if kind in ("mlstm", "slstm"):
        init = xlstm_mod.mlstm_init if kind == "mlstm" else \
            xlstm_mod.slstm_init
        return {"ln": torch.zeros((D,), **zeros),
                "cell": init(gen, cfg, dtype, device)}
    p = {"ln1": torch.zeros((D,), **zeros)}
    if kind == "attn":
        p["attn"] = attn.gqa_init(gen, cfg, dtype, device)
    elif kind == "mla":
        p["attn"] = attn.mla_init(gen, cfg, dtype, device)
    elif kind == "rec":
        p["rec"] = rec_mod.rglru_init(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    p["ln2"] = torch.zeros((D,), **zeros)
    p["mlp"] = (moe_mod.moe_init(gen, cfg, dtype, device)
                if kind == "attn" and cfg.is_moe else
                swiglu_init(gen, D, cfg.d_ff, dtype, device))
    return p


def _block_cache_init(cfg, kind: str, batch: int, s_max: int, dtype,
                      device) -> Params:
    if kind == "attn":
        return attn.gqa_cache_init(cfg, batch, s_max, _window(cfg), dtype,
                                   device)
    if kind == "mla":
        return attn.mla_cache_init(cfg, batch, s_max, dtype, device)
    if kind == "rec":
        return rec_mod.rglru_cache_init(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm_mod.mlstm_cache_init(cfg, batch, dtype, device)
    if kind == "slstm":
        return xlstm_mod.slstm_cache_init(cfg, batch, device)
    raise ValueError(kind)


def _tp_out(y: torch.Tensor, sp: bool) -> torch.Tensor:
    """A partial output summed over 'model': reduce-scattered along the
    sequence when the residual is sequence-parallel, else all-reduced
    (differentiable: ``collectives.scatter`` / ``reduce_partial``)."""
    if shd.axis_size("model") == 1:
        return y
    return coll.scatter(y, "model", dim=1) if sp \
        else coll.reduce_partial(y, "model")


def _sp_gather(x: torch.Tensor, sp: bool) -> torch.Tensor:
    """The whole sequence of a sequence-parallel activation."""
    return coll.gather(x, "model", dim=1) if sp else x


def _tp_enter(h: torch.Tensor, sp: bool) -> torch.Tensor:
    """A whole (not sequence-parallel) residual entering the per-rank work
    of the 'model' ranks: its backward sums their partial cotangents."""
    return h if sp else coll.enter(h, "model")


def _ffn(p: Params, cfg, kind: str, x: torch.Tensor, sp: bool = False
         ) -> torch.Tensor:
    """A block's FFN: the MoE for an ``attn`` block of an MoE config (its
    aux loss discarded at serving, as the JAX ``lm_prefill`` does), else a
    dense SwiGLU."""
    if kind == "attn" and cfg.is_moe:
        return moe_mod.moe_apply(p, cfg, x, seq_sharded=sp)[0]
    return _tp_out(swiglu(p, _sp_gather(x, sp)), sp)


def _xlstm_cell(kind: str):
    return xlstm_mod.mlstm_forward if kind == "mlstm" else \
        xlstm_mod.slstm_forward


def _block_prefill(p: Params, cfg, kind: str, h: torch.Tensor,
                   cache: Params, sp: bool = False
                   ) -> Tuple[torch.Tensor, Params]:
    if kind in ("mlstm", "slstm"):
        y, state = _xlstm_cell(kind)(p["cell"], cfg,
                                     rmsnorm(h, p["ln"], cfg.norm_eps),
                                     return_state=True)
        return h + y, state
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, cache = attn.gqa_prefill(p["attn"], cfg, _sp_gather(x, sp), cache,
                                    _window(cfg))
        y = _tp_out(y, sp)
    elif kind == "mla":
        y, cache = attn.mla_prefill(p["attn"], cfg, x, cache)
    elif kind == "rec":
        y, cache = rec_mod.rglru_prefill(p["rec"], cfg, x)
    else:
        raise ValueError(kind)
    h = h + y
    return h + _ffn(p["mlp"], cfg, kind, rmsnorm(h, p["ln2"], cfg.norm_eps),
                    sp), cache


def _block_decode(p: Params, cfg, kind: str, h: torch.Tensor,
                  cache: Params, pos: int) -> Tuple[torch.Tensor, Params]:
    if kind in ("mlstm", "slstm"):
        decode = xlstm_mod.mlstm_decode if kind == "mlstm" else \
            xlstm_mod.slstm_decode
        y, cache = decode(p["cell"], cfg, rmsnorm(h, p["ln"], cfg.norm_eps),
                          cache)
        return h + y, cache
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, cache = attn.gqa_decode(p["attn"], cfg, x, cache, pos,
                                   _window(cfg))
        y = _tp_out(y, False)
    elif kind == "mla":
        y, cache = attn.mla_decode(p["attn"], cfg, x, cache, pos)
    elif kind == "rec":
        y, cache = rec_mod.rglru_decode(p["rec"], cfg, x, cache)
    else:
        raise ValueError(kind)
    h = h + y
    return h + _ffn(p["mlp"], cfg, kind, rmsnorm(h, p["ln2"], cfg.norm_eps)), \
        cache


def _block_fwd(p: Params, cfg, kind: str, h: torch.Tensor,
               aux: torch.Tensor, sp: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / no-cache forward of one block: returns (h, aux), the
    MoE FFN of an ``attn`` block adding its router aux loss to the float32
    carry ``aux`` (as the JAX ``_block_fwd``).  On a mesh ``p`` is the
    block's gathered weights; ``sp``: the residual is sequence-parallel."""
    if kind in ("mlstm", "slstm"):
        return h + _xlstm_cell(kind)(p["cell"], cfg, rmsnorm(
            h, p["ln"], cfg.norm_eps)), aux
    x = rmsnorm(_tp_enter(h, sp), p["ln1"], cfg.norm_eps)
    if kind == "attn":
        h = h + _tp_out(attn.gqa_forward(p["attn"], cfg, _sp_gather(x, sp),
                                         _window(cfg)), sp)
    elif kind == "mla":
        h = h + attn.mla_forward(p["attn"], cfg, x)
    elif kind == "rec":
        h = h + rec_mod.rglru_forward(p["rec"], cfg, x)
    else:
        raise ValueError(kind)
    x = rmsnorm(_tp_enter(h, sp), p["ln2"], cfg.norm_eps)
    if kind == "attn" and cfg.is_moe:
        y, a = moe_mod.moe_apply(p["mlp"], cfg, x, seq_sharded=sp)
        return h + y, aux + a
    return h + _tp_out(swiglu(p["mlp"], _sp_gather(x, sp)), sp), aux


# ---------------------------------------------------------------------------
# full-model init
# ---------------------------------------------------------------------------

def init_stacked(make, n: int) -> Any:
    """``n`` trees from ``make()``, drawn in turn, stacked leaf by leaf
    on a new leading axis.  Each tree is copied into preallocated stacks
    as it is drawn, so the peak is the stack and one tree (stacking a
    list of them would hold every tree beside the stack)."""
    first = make()

    def alloc(x):
        return x.new_empty((n, *x.shape))

    def fill(out, tree, j):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(out[k], v, j)
            else:
                out[k][j].copy_(v)

    def empty(tree):
        return {k: empty(v) if isinstance(v, dict) else alloc(v)
                for k, v in tree.items()}

    out = empty(first)
    fill(out, first, 0)
    del first
    for j in range(1, n):
        fill(out, make(), j)
    return out


def _keep_tree(keep, path: tuple, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _keep_tree(keep, path + (k,), v) for k, v in tree.items()}
    return keep(path, tree)


def _index(tree: Any, j: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


def init_lm_params(cfg, gen: torch.Generator, device: torch.device,
                   keep=None) -> Params:
    """Random weights drawn from ``gen`` on ``device`` (``meta`` makes the
    shapes only), in the JAX package's layout and dtypes.  ``keep(path,
    leaf)``, if given, maps each leaf as it is drawn (a layer's leaf under
    ``("body", "b<i>", ...)`` before it is stacked): the sharded init keeps
    this rank's block of it."""
    dt = dtype_of(cfg)
    period, full, tail = _period(cfg)
    keep = keep or (lambda path, leaf: leaf)

    def block(path, kind):
        return _keep_tree(keep, path, _block_init(gen, cfg, kind, dt, device))

    params: Params = {
        "embed": keep(("embed",), embed_init(gen, cfg.vocab_padded,
                                             cfg.d_model, dt, device)),
        "final_norm": keep(("final_norm",), torch.zeros(
            (cfg.d_model,), dtype=dt, device=device)),
        "lm_head": keep(("lm_head",), dense_init(
            gen, cfg.d_model, cfg.vocab_padded, dt, device)),
    }
    if cfg.frontend == "vision":
        params["vis_proj"] = keep(("vis_proj",), dense_init(
            gen, cfg.d_model, cfg.d_model, dt, device))
    params["body"] = {
        f"b{i}": init_stacked(
            lambda: block(("body", f"b{i}"), kind), full)
        for i, kind in enumerate(period)}
    params["tail"] = {f"t{i}": block(("tail", f"t{i}"), kind)
                      for i, kind in enumerate(tail)}
    return params


def init_cache(cfg, batch: int, s_max: int, device: torch.device) -> Params:
    dt = dtype_of(cfg)
    period, full, tail = _period(cfg)
    return {
        "body": {f"b{i}": [_block_cache_init(cfg, kind, batch, s_max, dt,
                                             device) for _ in range(full)]
                 for i, kind in enumerate(period)},
        "tail": {f"t{i}": _block_cache_init(cfg, kind, batch, s_max, dt,
                                            device)
                 for i, kind in enumerate(tail)},
        "pos": 0}


def check_mesh(cfg, train: bool = False) -> None:
    """Raise where the active mesh's tensor parallelism does not cover
    ``cfg``: tp > 1 serves and trains the GQA transformer (dense or MoE
    FFN) only, with its heads resolved for tp
    (``configs.resolve_for_tp``); any mesh trains the decoder families
    only."""
    if train and cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family does not train on a "
            f"mesh")
    tp = shd.axis_size("model")
    if tp == 1:
        return
    kinds = set(_period(cfg)[0]) | set(_period(cfg)[2])
    if cfg.family == "encdec" or cfg.frontend != "none" or kinds != {"attn"}:
        raise NotImplementedError(
            f"tensor parallelism (model={tp}) serves the GQA / MoE "
            f"transformer; {cfg.name} is of family {cfg.family!r} (layer "
            f"kinds {sorted(kinds)}, frontend {cfg.frontend!r})")
    if cfg.heads % tp:
        raise ValueError(f"{cfg.heads} Q heads do not split over model={tp}: "
                         f"resolve the config with resolve_for_tp(cfg, {tp})")


# ---------------------------------------------------------------------------
# stack execution
# ---------------------------------------------------------------------------

def _run_stack(params: Params, cfg, h: torch.Tensor, cache: Params,
               step) -> Tuple[torch.Tensor, Params]:
    """Apply ``step(p, kind, h, layer_cache) -> (h, layer_cache)`` over
    the body periods, then the tail; returns h and the new caches."""
    period, full, tail = _period(cfg)
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


def _gathered(tree: Any, specs: Any) -> Any:
    """The whole weights of this rank's training-layout blocks ``tree``
    (a leaf or a subtree) placed by ``specs``: each leaf all-gathered over
    'data' (``sharding.fsdp_gather``) and, at tp > 1, a leaf that the
    'model' ranks hold alike passed through ``collectives.enter`` (see
    the module docstring).  ``tree`` itself outside a mesh."""
    if specs is None:
        return tree
    tp = shd.axis_size("model")

    def one(path, leaf):
        spec = shd.leaf_at(specs, path)
        w = shd.fsdp_gather(leaf, spec)
        if tp > 1 and "model" not in shd.spec_axes(spec):
            w = coll.enter(w, "model")
        return w

    return shd.tree_map_with_path(one, tree)


def forward_hidden(params: Params, cfg, h: torch.Tensor,
                   mode: str = "scan", remat: bool = False,
                   specs: Optional[Params] = None, sp: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the full block stack for training; returns (h, moe_aux), the
    float32 sum of the MoE layers' aux losses in layer order (0 for a
    dense stack).

    ``remat`` recomputes each body period ("superblock") in the backward
    instead of keeping its activations (``torch.utils.checkpoint``, the
    counterpart of ``jax.checkpoint`` around the scanned superblock); the
    aux carry passes through it with h.  The tail stays outside it, as in
    the JAX package.  On a mesh ``specs`` (``Model.train_specs``) places
    the local params, each period's weights are gathered inside its
    checkpoint, and ``sp`` says the residual is sequence-parallel."""
    _check_mode(mode)
    period, full, tail = _period(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    body_specs = None if specs is None else shd.tree_map_with_path(
        lambda path, spec: spec[1:], specs["body"])     # a period's slice

    def superblock(h, aux, pslice):
        pslice = _gathered(pslice, body_specs)
        for i, kind in enumerate(period):
            h, aux = _block_fwd(pslice[f"b{i}"], cfg, kind, h, aux, sp)
        return h, aux

    for pslice in _unbind(params["body"], full):
        h, aux = (checkpoint(superblock, h, aux, pslice, use_reentrant=False)
                  if remat else superblock(h, aux, pslice))
    for i, kind in enumerate(tail):
        key = f"t{i}"
        p = _gathered(params["tail"][key],
                      None if specs is None else specs["tail"][key])
        h, aux = _block_fwd(p, cfg, kind, h, aux, sp)
    return h, aux


def _embed_tokens(params: Params, cfg, batch, sp: bool = False
                  ) -> torch.Tensor:
    """The token embeddings of ``batch["tokens"]`` (B, S), and for the
    vision frontend the projected ``batch["image_embeds"]`` (B, F, D) in
    front of them: (B, F + S, D).  Under tensor parallelism the lookup is
    vocab-parallel; ``sp`` returns this rank's sequence block."""
    tokens = batch["tokens"]
    if shd.axis_size("model") > 1:
        emb = params["embed"]                       # this rank's vocab rows
        ids = tokens - shd.axis_index("model") * emb.shape[0]
        mine = (ids >= 0) & (ids < emb.shape[0])
        h = torch.where(mine[..., None], emb[ids.clamp(0, emb.shape[0] - 1)],
                        0.0)
        return _tp_out(h, sp)
    h = params["embed"][tokens]
    if cfg.frontend == "vision" and "image_embeds" in batch:
        vis = batch["image_embeds"].to(h.dtype) @ params["vis_proj"]
        h = torch.cat([vis, h], dim=1)
    return h


def _logits(params: Params, cfg, h: torch.Tensor) -> torch.Tensor:
    """Masked logits of final-normed h; under tensor parallelism the
    vocab columns are gathered first, so every rank holds them all (the
    gather's backward keeps this rank's columns of the cotangent, which
    every rank computes alike)."""
    logits = h @ params["lm_head"]
    if shd.axis_size("model") > 1:
        logits = coll.gather_replicated(logits, "model", dim=-1)
    return _mask_padded_vocab(cfg, logits)


def lm_loss(params: Params, cfg, batch, mode: str = "scan",
            remat: bool = False, aux_weight: float = 0.01,
            specs: Optional[Params] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S), plus ``aux_weight`` times the router aux
    sum for an MoE config; returns (loss, {"xent", "moe_aux"}), the JAX
    package's metrics.  With the vision frontend's ``image_embeds`` the
    loss is taken on the text positions only.

    As in the JAX ``lm_loss``, ``"xent"`` is the loss after the aux term
    is added (the reference rebinds ``loss`` before it builds the
    metrics); the port keeps that, so the metrics match.

    On a mesh ``params`` are this rank's training-layout blocks, placed
    by ``specs`` (``Model.train_specs``), and ``batch`` its batch block:
    the loss returned is the block's (what ``train.loop``
    differentiates), the metrics are averaged over the batch axes, so
    every rank reports the global batch's."""
    sp = False
    if shd.active_mesh() is not None:
        check_mesh(cfg, train=True)
        tp = shd.axis_size("model")
        S = batch["tokens"].shape[1]
        sp = tp > 1 and shd.SEQ_SHARD_ACTIVATIONS and S % tp == 0
        if tp > 1 and cfg.is_moe and S % tp:
            raise NotImplementedError(
                f"training {cfg.name} at model={tp} takes a sequence that "
                f"splits over model; got {S} tokens")
        if specs is None:
            raise ValueError("lm_loss on a mesh takes the params' specs "
                             "(Model.train_specs)")

    def top(name):
        return _gathered(params[name], None if specs is None else
                         specs[name])

    embed = {"embed": top("embed")}
    if cfg.frontend == "vision" and "image_embeds" in batch:
        embed["vis_proj"] = top("vis_proj")
    h, aux = forward_hidden(params, cfg, _embed_tokens(embed, cfg, batch, sp),
                            mode, remat, specs, sp)
    h = _sp_gather(rmsnorm(_tp_enter(h, sp), top("final_norm"),
                           cfg.norm_eps), sp)
    if cfg.frontend == "vision" and "image_embeds" in batch:
        h = h[:, batch["image_embeds"].shape[1]:]
    loss = softmax_xent(_logits({"lm_head": top("lm_head")}, cfg, h),
                        batch["labels"])
    if cfg.is_moe:
        loss = loss + aux_weight * aux
    metrics = {"xent": loss, "moe_aux": aux}
    if specs is not None:
        metrics = {k: coll.all_reduce(v.detach(), shd.BATCH_AXES, "avg")
                   for k, v in metrics.items()}
    return loss, metrics


def _mask_padded_vocab(cfg, logits: torch.Tensor) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) \
        >= cfg.vocab_size
    return logits.masked_fill(pad, torch.finfo(logits.dtype).min)


def lm_prefill_hidden(params: Params, cfg, batch, cache: Params
                      ) -> Tuple[torch.Tensor, Params]:
    """Prefill the stack over ``batch["tokens"]`` (B, S), behind the
    image embeddings of a vision config's ``batch["image_embeds"]`` (B, F,
    D): returns the final-normed hidden states of every position (B,
    F + S, D) and the populated cache.  On a mesh: this rank's batch
    block, every position."""
    if shd.active_mesh() is not None:
        check_mesh(cfg)
    tp = shd.axis_size("model")
    S = batch["tokens"].shape[1]
    sp = (tp > 1 and shd.SEQ_SHARD_ACTIVATIONS and S % tp == 0 and S > 1)
    h = _embed_tokens(params, cfg, batch, sp)
    n = h.shape[1] * (tp if sp else 1)

    def step(p, kind, h, c):
        return _block_prefill(p, cfg, kind, h, c, sp)

    h, new_cache = _run_stack(params, cfg, h, cache, step)
    new_cache["pos"] = n
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _sp_gather(h, sp), new_cache


def lm_prefill(params: Params, cfg, batch, cache: Params,
               mode: str = "unroll") -> Tuple[torch.Tensor, Params]:
    """Prefill: returns (last-position logits (B, 1, V), populated
    cache)."""
    _check_mode(mode)
    h, cache = lm_prefill_hidden(params, cfg, batch, cache)
    return _logits(params, cfg, h[:, -1:]), cache


def lm_decode_step(params: Params, cfg, cache: Params, tokens: torch.Tensor,
                   mode: str = "unroll") -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1). Returns (logits, cache)."""
    _check_mode(mode)
    pos = cache["pos"]
    h = _embed_tokens(params, cfg, {"tokens": tokens})

    def step(p, kind, h, c):
        return _block_decode(p, cfg, kind, h, c, pos)

    h, new_cache = _run_stack(params, cfg, h, cache, step)
    new_cache["pos"] = pos + 1
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h), new_cache
