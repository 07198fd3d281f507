"""GQA attention (full, sliding-window and local): the port of
``repro.models.attention`` for serving and training.

Prefill and training context goes through the ``flash_attention`` op:
the hand-written CUDA kernel on a CUDA tensor, its plain version on a
CPU tensor (its backward recomputes through the plain version).  Decode
attends one query over the cache in plain torch, as the JAX package does
in XLA.  Full attention keeps a (B, S_max, kvH, hd) cache; sliding-window
and local attention keep a ring of the window, the key at position p in
slot p mod s_buf.  The qwen3 family normalises q and k per head before
RoPE.  MLA comes with a later slice of the port.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.flash_attention.ops import flash_attention
from .common import Params, apply_rope, dense_init, rmsnorm


def attention_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, q_offset: int = 0, window: int = 0
                  ) -> torch.Tensor:
    """Causal (optionally windowed) attention context, q: (B,Sq,Hq,d),
    k, v: (B,Sk,Hkv,d).  Query i sits at position i + q_offset; the flash
    op places queries right-aligned, so q_offset must be Sk - Sq (0 for
    the prefill's Sq == Sk)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if q_offset != Sk - Sq:
        raise ValueError(f"attention_ctx places queries right-aligned: "
                         f"q_offset must be Sk - Sq = {Sk - Sq}; got "
                         f"{q_offset}")
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, window=window, scale=scale)


def gqa_init(gen: torch.Generator, cfg, dtype, device: torch.device
             ) -> Params:
    H, Hkv, hd, D = cfg.heads, cfg.kv_heads, cfg.hd, cfg.d_model
    p = {"wq": dense_init(gen, D, H * hd, dtype, device),
         "wk": dense_init(gen, D, Hkv * hd, dtype, device),
         "wv": dense_init(gen, D, Hkv * hd, dtype, device),
         "wo": dense_init(gen, H * hd, D, dtype, device)}
    # per-head RMSNorm of q and k before RoPE, given to the qwen3 family
    # by name as in src/repro/models/attention.py:148
    if cfg.name.startswith("qwen3"):
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.heads, cfg.kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_cache_init(cfg, batch: int, s_max: int, window: int, dtype,
                   device: torch.device) -> Params:
    s_buf = min(window, s_max) if window else s_max
    shape = (batch, s_buf, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gqa_seq(p: Params, cfg, x: torch.Tensor, window: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention over a whole sequence, x: (B, S, D); returns the output
    and the keys and values."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    ctx = attention_ctx(q, k, v, cfg.hd ** -0.5, window=window)
    return ctx.reshape(B, S, -1) @ p["wo"], k, v


def gqa_forward(p: Params, cfg, x: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """Training / prefill-without-cache forward, x: (B, S, D).
    Differentiable: the flash op's backward recomputes through its plain
    version."""
    return _gqa_seq(p, cfg, x, window)[0]


def gqa_prefill(p: Params, cfg, x: torch.Tensor, cache: Params,
                window: int = 0) -> Tuple[torch.Tensor, Params]:
    """Prefill: forward + a new populated cache; returns (out, cache).

    The cache keeps the last s_buf keys and values, the one at position p
    in slot p mod s_buf, which is where ``gqa_decode`` reads it.  (The
    JAX package stores them at slots 0..s_buf-1, which agrees only when
    S <= s_buf or S is a multiple of s_buf.)
    """
    S = x.shape[1]
    out, k, v = _gqa_seq(p, cfg, x, window)
    s_buf = cache["k"].shape[1]
    if S >= s_buf:
        if not window and S > s_buf:
            raise ValueError(f"prompt of {S} tokens exceeds the full-"
                             f"attention cache of {s_buf}")
        shift = S % s_buf
        cache = {"k": torch.roll(k[:, -s_buf:], shift, dims=1),
                 "v": torch.roll(v[:, -s_buf:], shift, dims=1)}
    else:
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, :S], cv[:, :S] = k, v
        cache = {"k": ck, "v": cv}
    return out, cache


def gqa_decode(p: Params, cfg, x: torch.Tensor, cache: Params, pos: int,
               window: int = 0) -> Tuple[torch.Tensor, Params]:
    """One-token decode with KV cache. x: (B, 1, D); pos: the new token's
    position.  Writes the new key and value into the cache in place (one
    slot, instead of copying the whole buffer each step) and returns it."""
    B = x.shape[0]
    positions = torch.full((1, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    ck, cv = cache["k"], cache["v"]
    s_buf = ck.shape[1]
    if not window and pos >= s_buf:
        raise ValueError(f"position {pos} is past the full-attention cache "
                         f"of {s_buf}")
    slot = pos % s_buf if window else pos
    ck[:, slot], cv[:, slot] = k[:, 0], v[:, 0]
    # positions of cache entries: ring for window, prefix for full
    idx = torch.arange(s_buf, device=x.device)
    if window:
        entry_pos = torch.where(idx <= slot, pos - slot + idx,
                                pos - slot + idx - s_buf)
        valid = (entry_pos >= max(0, pos - window + 1)) & (entry_pos >= 0)
    else:
        valid = idx <= pos
    Hkv, hd, H = cfg.kv_heads, cfg.hd, cfg.heads
    g = H // Hkv
    qg = q.reshape(B, 1, Hkv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, ck).float()
    scores = (scores * hd ** -0.5).masked_fill(
        ~valid, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, cv).reshape(B, 1, H * hd)
    return ctx @ p["wo"], {"k": ck, "v": cv}
