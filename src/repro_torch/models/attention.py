"""GQA attention (full, sliding-window and local) and MLA: the port of
``repro.models.attention`` for serving and training.

Prefill and training context goes through the ``flash_attention`` op:
the hand-written CUDA kernel on a CUDA tensor, its plain version on a
CPU tensor (its backward recomputes through the plain version).  Heads
whose dims are no head dim of the kernel (phi3's 96, h2o-danube's 120,
MLA's) are zero-padded to the next one (``_flash``: exact, zero columns
add nothing to q.k or to the context); a head wider than the kernel's
widest raises, naming its dims.  Decode
attends one query over the cache in plain torch, as the JAX package does
in XLA.  Full attention keeps a (B, S_max, kvH, hd) cache; sliding-window
and local attention keep a ring of the window, the key at position p in
slot p mod s_buf.  The qwen3 family normalises q and k per head before
RoPE.

MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2) expands
per-head keys and values from a shared latent for prefill and training;
its q and k heads (``qk_nope + qk_rope`` dims) and v heads
(``v_head_dim``) differ, and both are padded to one kernel head dim.
Decode caches the latent and the rope key and attends in latent space
(``wk_b`` folded into q, ``wv_b`` applied after), in plain torch as the
JAX package does.

Under tensor parallelism (a mesh whose ``model`` axis has tp > 1; see
``distributed.sharding``) each rank holds whole heads: the columns of
``wq``, ``wk``, ``wv`` and the rows of ``wo`` of its H/tp Q heads and,
where tp divides them, of its KV heads (the cache holds those), else of
every KV head (the cache holds all of them, and each rank attends with
the KV heads of its Q heads).  ``q_norm`` and ``k_norm`` are replicated.
The GQA functions then return this rank's partial sum of the output
projection; the caller reduces it over ``model``
(``models.transformer``).
"""
from __future__ import annotations

from typing import Tuple

import torch

import torch.nn.functional as F

from ..distributed import collectives as coll
from ..distributed.sharding import axis_index, axis_size
from ..kernels.flash_attention.kernel import HEAD_DIMS
from ..kernels.flash_attention.ops import flash_attention
from .common import Params, apply_rope, dense_init, rmsnorm


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int, scale: float) -> torch.Tensor:
    """The flash op on q, k (B, S, H, dq) and v (B, Sk, Hkv, dv), each
    zero-padded to the least head dim of the kernel that holds
    max(dq, dv); returns (B, Sq, Hq, dv).  The padding is exact: zero
    columns add nothing to q.k or to the context's first dv columns."""
    dq, dv = q.shape[-1], v.shape[-1]
    d = next((h for h in HEAD_DIMS if h >= max(dq, dv)), None)
    if d is None:
        raise ValueError(f"attention heads of q.k dim {dq} and v dim {dv}: "
                         f"the flash kernel takes head dims {HEAD_DIMS}")
    q, k, v = (F.pad(t, (0, d - t.shape[-1])) if t.shape[-1] != d
               else t.contiguous() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window,
                          scale=scale)
    return out if d == dv else out[..., :dv]


def attention_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, q_offset: int = 0, window: int = 0
                  ) -> torch.Tensor:
    """Causal (optionally windowed) attention context, q: (B,Sq,Hq,dq),
    k: (B,Sk,Hkv,dq), v: (B,Sk,Hkv,dv).  Query i sits at position
    i + q_offset; the flash op places queries right-aligned, so q_offset
    must be Sk - Sq (0 for the prefill's Sq == Sk)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if q_offset != Sk - Sq:
        raise ValueError(f"attention_ctx places queries right-aligned: "
                         f"q_offset must be Sk - Sq = {Sk - Sq}; got "
                         f"{q_offset}")
    return _flash(q, k, v, True, window, scale)


def noncausal_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Attention context with every query seeing every key (an encoder's
    self-attention, cross-attention), q: (B,Sq,Hq,d), k, v:
    (B,Sk,Hkv,d), Sq and Sk free."""
    return _flash(q, k, v, False, 0, scale)


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
    """q, k, v (B, S, heads, hd) of this rank's heads (every head on one
    device)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(B, S, -1, hd)
    k, v = x @ p["wk"], x @ p["wv"]
    if k.shape[-1] < cfg.kv_heads * hd and cfg.kv_heads % axis_size("model"):
        # KV columns split inside heads: every rank takes all of them (and
        # uses those of its Q heads, so the gather's backward sums)
        k, v = (coll.gather(t, "model", dim=-1) for t in (k, v))
    k, v = k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_of_local_q(cfg, n_q: int, k: torch.Tensor, v: torch.Tensor):
    """The KV heads that this rank's ``n_q`` Q heads attend with: k and v
    as they are where the KV heads are split with the Q heads (or on one
    device); where this rank holds every KV head, those of its Q heads
    (contiguous groups, else one KV head per Q head)."""
    tp = axis_size("model")
    if tp == 1 or k.shape[2] * tp == cfg.kv_heads:
        return k, v
    g = cfg.heads // cfg.kv_heads
    first = axis_index("model") * n_q
    if n_q % g == 0 and first % g == 0:
        sel = slice(first // g, (first + n_q) // g)
    else:
        sel = torch.arange(first, first + n_q, device=k.device) // g
    return k[:, :, sel], v[:, :, sel]


def gqa_cache_init(cfg, batch: int, s_max: int, window: int, dtype,
                   device: torch.device) -> Params:
    s_buf = min(window, s_max) if window else s_max
    shape = (batch, s_buf, cfg.kv_heads, cfg.hd)     # every KV head
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gqa_seq(p: Params, cfg, x: torch.Tensor, window: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention over a whole sequence, x: (B, S, D); returns the output
    and the keys and values."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    ctx = attention_ctx(q, *_kv_of_local_q(cfg, q.shape[2], k, v),
                        cfg.hd ** -0.5, window=window)
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
    hd, H = cfg.hd, q.shape[2]
    kk, vv = _kv_of_local_q(cfg, H, ck, cv)
    Hkv = kk.shape[2]
    g = H // Hkv
    qg = q.reshape(B, 1, Hkv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kk).float()
    scores = (scores * hd ** -0.5).masked_fill(
        ~valid, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(vv.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, vv).reshape(B, 1, H * hd)
    return ctx @ p["wo"], {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, dtype, device: torch.device
             ) -> Params:
    D, H = cfg.d_model, cfg.heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    zeros = dict(dtype=dtype, device=device)
    return {
        "wq_a": dense_init(gen, D, qr, dtype, device),
        "q_norm": torch.zeros((qr,), **zeros),
        "wq_b": dense_init(gen, qr, H * (dn + dr), dtype, device),
        "wkv_a": dense_init(gen, D, kvr + dr, dtype, device),
        "kv_norm": torch.zeros((kvr,), **zeros),
        "wk_b": dense_init(gen, kvr, H * dn, dtype, device),  # latent->k_nope
        "wv_b": dense_init(gen, kvr, H * dv, dtype, device),  # latent->v
        "wo": dense_init(gen, H * dv, D, dtype, device),
    }


def _mla_q(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    H, dn, dr = cfg.heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv = x @ p["wkv_a"]
    latent = rmsnorm(kv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., kvr:].reshape(B, S, 1, dr), positions,
                        cfg.rope_theta)
    return latent, k_rope


def mla_forward(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train / prefill: expand per-head K/V from the latent (the standard
    form), x: (B, S, D)."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = (latent @ p["wk_b"]).reshape(B, S, H, dn)
    v = (latent @ p["wv_b"]).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], -1)
    ctx = attention_ctx(q, k, v, (dn + dr) ** -0.5)
    return ctx.reshape(B, S, -1) @ p["wo"]


def mla_cache_init(cfg, batch: int, s_max: int, dtype,
                   device: torch.device) -> Params:
    return {"latent": torch.zeros((batch, s_max, cfg.kv_lora_rank),
                                  dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, s_max, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p: Params, cfg, x: torch.Tensor, cache: Params
                ) -> Tuple[torch.Tensor, Params]:
    """Prefill: forward + a new cache holding the prompt's latent and
    rope key in slots 0..S-1."""
    S = x.shape[1]
    if S > cache["latent"].shape[1]:
        raise ValueError(f"prompt of {S} tokens exceeds the MLA cache of "
                         f"{cache['latent'].shape[1]}")
    out = mla_forward(p, cfg, x)
    positions = torch.arange(S, device=x.device)[None, :]
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    cl, cr = cache["latent"].clone(), cache["k_rope"].clone()
    cl[:, :S], cr[:, :S] = latent, k_rope[:, :, 0]
    return out, {"latent": cl, "k_rope": cr}


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Params, pos: int
               ) -> Tuple[torch.Tensor, Params]:
    """Absorbed decode: scores and context computed in latent space.
    x: (B, 1, D); cache: latent (B, S, kvr), k_rope (B, S, dr), written
    in place at ``pos``."""
    B = x.shape[0]
    H, dn, dr, dv = cfg.heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    latent, k_rope = cache["latent"], cache["k_rope"]
    S = latent.shape[1]
    if pos >= S:
        raise ValueError(f"position {pos} is past the MLA cache of {S}")
    positions = torch.full((1, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)      # (B,1,H,dn), (B,1,H,dr)
    latent_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    latent[:, pos], k_rope[:, pos] = latent_new[:, 0], k_rope_new[:, 0, 0]
    # absorb wk_b into q: q_eff (B, H, kvr)
    wk = p["wk_b"].reshape(kvr, H, dn)
    q_eff = torch.einsum("bhd,khd->bhk", q_nope[:, 0], wk)
    scores = (torch.einsum("bhk,bsk->bhs", q_eff, latent)
              + torch.einsum("bhd,bsd->bhs", q_rope[:, 0], k_rope)).float()
    scores = scores * (dn + dr) ** -0.5
    valid = torch.arange(S, device=x.device) <= pos
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(latent.dtype)
    ctx_latent = torch.einsum("bhs,bsk->bhk", probs, latent)  # (B, H, kvr)
    wv = p["wv_b"].reshape(kvr, H, dv)
    ctx = torch.einsum("bhk,khd->bhd", ctx_latent, wv)
    return ctx.reshape(B, 1, H * dv) @ p["wo"], {"latent": latent,
                                                  "k_rope": k_rope}
