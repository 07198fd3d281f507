"""Encoder-decoder model (the seamless-m4t-medium backbone): the port of
``repro.models.encdec``.

The speech frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, S_src, d_model).  Encoder: bidirectional
self-attention.  Decoder: causal self-attention, then cross-attention
into the encoder's output.  Parameters keep the JAX package's layout
(``embed``, ``enc`` and ``dec`` stacked over layers, ``enc_norm``,
``final_norm``, ``lm_head``), so weights carry across leaf for leaf.

The encoder's self-attention and the cross-attention of training and
prefill go through the ``flash_attention`` op non-causally; the
decoder's self-attention is the GQA block's (``gqa_prefill`` /
``gqa_decode``).  A decode step attends its one query over the cached
encoder keys and values in plain torch, as ``gqa_decode`` does.  The
cache keeps the JAX package's stacked layout: ``{"self": {"k", "v"}
(n_dec, B, S_max, kvH, hd), "cross": {"k", "v"} (n_dec, B, S_src, H, hd),
"pos": int}``; a decode step writes its keys and values in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .common import (Params, apply_rope, dense_init, dtype_of, embed_init,
                     gelu_mlp, gelu_mlp_init, rmsnorm, softmax_xent)
from .transformer import _index, _mask_padded_vocab, init_stacked


def _xattn_init(gen, cfg, dtype, device) -> Params:
    H, hd, D = cfg.heads, cfg.hd, cfg.d_model
    return {"wq": dense_init(gen, D, H * hd, dtype, device),
            "wk": dense_init(gen, D, H * hd, dtype, device),
            "wv": dense_init(gen, D, H * hd, dtype, device),
            "wo": dense_init(gen, H * hd, D, dtype, device)}


def _enc_layer_init(gen, cfg, dtype, device) -> Params:
    D = cfg.d_model
    zeros = dict(dtype=dtype, device=device)
    return {"ln1": torch.zeros((D,), **zeros),
            "attn": attn.gqa_init(gen, cfg, dtype, device),
            "ln2": torch.zeros((D,), **zeros),
            "mlp": gelu_mlp_init(gen, D, cfg.d_ff, dtype, device)}


def _dec_layer_init(gen, cfg, dtype, device) -> Params:
    D = cfg.d_model
    zeros = dict(dtype=dtype, device=device)
    return {"ln1": torch.zeros((D,), **zeros),
            "self": attn.gqa_init(gen, cfg, dtype, device),
            "ln_x": torch.zeros((D,), **zeros),
            "cross": _xattn_init(gen, cfg, dtype, device),
            "ln2": torch.zeros((D,), **zeros),
            "mlp": gelu_mlp_init(gen, D, cfg.d_ff, dtype, device)}


def init_encdec_params(cfg, gen: torch.Generator, device: torch.device
                       ) -> Params:
    """Random weights drawn from ``gen`` on ``device`` (``meta`` makes the
    shapes only), in the JAX package's layout and dtypes."""
    dt = dtype_of(cfg)
    D = cfg.d_model
    return {
        "embed": embed_init(gen, cfg.vocab_padded, D, dt, device),
        "enc": init_stacked(lambda: _enc_layer_init(gen, cfg, dt, device),
                            cfg.n_enc_layers),
        "dec": init_stacked(lambda: _dec_layer_init(gen, cfg, dt, device),
                            cfg.n_dec_layers),
        "enc_norm": torch.zeros((D,), dtype=dt, device=device),
        "final_norm": torch.zeros((D,), dtype=dt, device=device),
        "lm_head": dense_init(gen, D, cfg.vocab_padded, dt, device),
    }


def _bidir_attn(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Non-causal full self-attention for the encoder, x: (B, S, D)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.heads, cfg.kv_heads, cfg.hd
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope((x @ p["wq"]).reshape(B, S, H, hd), positions,
                   cfg.rope_theta)
    k = apply_rope((x @ p["wk"]).reshape(B, S, Hkv, hd), positions,
                   cfg.rope_theta)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    ctx = attn.noncausal_ctx(q, k, v, hd ** -0.5)
    return ctx.reshape(B, S, -1) @ p["wo"]


def _cross_kv(p: Params, cfg, enc_out: torch.Tensor):
    """The cross-attention's keys and values of the encoder's output:
    (B, S_src, H, hd) each."""
    B, Sk, _ = enc_out.shape
    H, hd = cfg.heads, cfg.hd
    return ((enc_out @ p["wk"]).reshape(B, Sk, H, hd),
            (enc_out @ p["wv"]).reshape(B, Sk, H, hd))


def _cross_ctx(p: Params, cfg, x: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B, S, D) over keys and values of the encoder
    through the flash op, non-causal."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.heads, cfg.hd)
    ctx = attn.noncausal_ctx(q, k, v, cfg.hd ** -0.5)
    return ctx.reshape(B, S, -1) @ p["wo"]


def _cross_attn(p: Params, cfg, x: torch.Tensor, enc_out: torch.Tensor
                ) -> torch.Tensor:
    return _cross_ctx(p, cfg, x, *_cross_kv(p, cfg, enc_out))


def _cross_attn_cached(p: Params, cfg, x: torch.Tensor, kv_cache: Params
                       ) -> torch.Tensor:
    """Decode-time cross-attention against the cached encoder K/V, in
    plain torch (the JAX package's ``grouped_attention`` with no key
    masked)."""
    B, S, _ = x.shape
    H, hd = cfg.heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k, v = kv_cache["k"], kv_cache["v"]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * hd ** -0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhst,bthd->bshd", probs, v)
    return ctx.reshape(B, S, -1) @ p["wo"]


def encode(params: Params, cfg, frame_embeds: torch.Tensor,
           mode: str = "scan") -> torch.Tensor:
    """The encoder over frame embeddings (B, S_src, D); returns its
    normed output (B, S_src, D).  ``mode`` is accepted for the JAX
    package's signature: both modes are the same eager loop."""
    h = frame_embeds.to(dtype_of(cfg))
    for i in range(cfg.n_enc_layers):
        p = _index(params["enc"], i)
        h = h + _bidir_attn(p["attn"], cfg, rmsnorm(h, p["ln1"],
                                                    cfg.norm_eps))
        h = h + gelu_mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _dec_layer(h: torch.Tensor, enc_out: torch.Tensor, p: Params, cfg
               ) -> torch.Tensor:
    h = h + attn.gqa_forward(p["self"], cfg, rmsnorm(h, p["ln1"],
                                                     cfg.norm_eps))
    h = h + _cross_attn(p["cross"], cfg, rmsnorm(h, p["ln_x"], cfg.norm_eps),
                        enc_out)
    return h + gelu_mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))


def decoder_hidden(params: Params, cfg, batch, remat: bool = False
                   ) -> torch.Tensor:
    """The decoder's final-normed hidden states (B, S_tgt, D) of
    ``batch["tokens"]`` teacher-forced against the encoding of
    ``batch["frame_embeds"]``.  ``remat`` recomputes each decoder layer
    in the backward (the JAX package checkpoints each one)."""
    enc_out = encode(params, cfg, batch["frame_embeds"])
    h = params["embed"][batch["tokens"]]
    for i in range(cfg.n_dec_layers):
        p = _index(params["dec"], i)
        h = (checkpoint(_dec_layer, h, enc_out, p, cfg, use_reentrant=False)
             if remat else _dec_layer(h, enc_out, p, cfg))
    return rmsnorm(h, params["final_norm"], cfg.norm_eps)


def encdec_loss(params: Params, cfg, batch, mode: str = "scan",
                remat: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean cross entropy of the decoder's logits against
    ``batch["labels"]`` (B, S_tgt); returns (loss, {"xent"})."""
    h = decoder_hidden(params, cfg, batch, remat)
    logits = _mask_padded_vocab(cfg, h @ params["lm_head"])
    loss = softmax_xent(logits, batch["labels"])
    return loss, {"xent": loss}


def encdec_cache_init(cfg, batch: int, s_max: int, device: torch.device
                      ) -> Params:
    dt = dtype_of(cfg)
    n, H, hd = cfg.n_dec_layers, cfg.heads, cfg.hd
    self_shape = (n, batch, s_max, cfg.kv_heads, hd)
    cross_shape = (n, batch, s_max, H, hd)
    return {"self": {"k": torch.zeros(self_shape, dtype=dt, device=device),
                     "v": torch.zeros(self_shape, dtype=dt, device=device)},
            "cross": {"k": torch.zeros(cross_shape, dtype=dt, device=device),
                      "v": torch.zeros(cross_shape, dtype=dt,
                                       device=device)},
            "pos": 0}


def _layer_cache(cache: Params, i: int) -> Params:
    return {"k": cache["k"][i], "v": cache["v"][i]}


def encdec_prefill(params: Params, cfg, batch, cache: Params,
                   mode: str = "unroll") -> Tuple[torch.Tensor, Params]:
    """Encode the source, keep each decoder layer's cross K/V, prefill the
    decoder's self-attention cache with the (short) target prefix; returns
    (last-position logits (B, 1, V), the new cache)."""
    enc_out = encode(params, cfg, batch["frame_embeds"], mode)
    h = params["embed"][batch["tokens"]]
    self_k, self_v, cross_k, cross_v = [], [], [], []
    for i in range(cfg.n_dec_layers):
        p = _index(params["dec"], i)
        y, c = attn.gqa_prefill(p["self"], cfg,
                                rmsnorm(h, p["ln1"], cfg.norm_eps),
                                _layer_cache(cache["self"], i), 0)
        h = h + y
        self_k.append(c["k"])
        self_v.append(c["v"])
        ck, cv = _cross_kv(p["cross"], cfg, enc_out)
        cross_k.append(ck)
        cross_v.append(cv)
        h = h + _cross_ctx(p["cross"], cfg,
                           rmsnorm(h, p["ln_x"], cfg.norm_eps), ck, cv)
        h = h + gelu_mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, h[:, -1:] @ params["lm_head"])
    return logits, {
        "self": {"k": torch.stack(self_k), "v": torch.stack(self_v)},
        "cross": {"k": torch.stack(cross_k), "v": torch.stack(cross_v)},
        "pos": h.shape[1]}


def encdec_decode_step(params: Params, cfg, cache: Params,
                       tokens: torch.Tensor, mode: str = "unroll"
                       ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1). Returns (logits, cache)."""
    pos = cache["pos"]
    h = params["embed"][tokens]
    for i in range(cfg.n_dec_layers):
        p = _index(params["dec"], i)
        y, _ = attn.gqa_decode(p["self"], cfg,
                               rmsnorm(h, p["ln1"], cfg.norm_eps),
                               _layer_cache(cache["self"], i), pos, 0)
        h = h + y
        h = h + _cross_attn_cached(p["cross"], cfg,
                                   rmsnorm(h, p["ln_x"], cfg.norm_eps),
                                   _layer_cache(cache["cross"], i))
        h = h + gelu_mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, h @ params["lm_head"])
    return logits, {"self": cache["self"], "cross": cache["cross"],
                    "pos": pos + 1}
