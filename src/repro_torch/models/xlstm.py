"""xLSTM blocks (arXiv:2405.04517): the port of ``repro.models.xlstm``,
a chunkwise-parallel mLSTM and a sequential sLSTM.

mLSTM (matrix memory):
    C_t = f_t C_{t-1} + i_t v_t k_t^T        (per head, dh x dh memory)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))
with exponential input gates stabilized by the running log-max m_t.  The
sequence form is CHUNKWISE: quadratic within a chunk of ``MLSTM_CHUNK``
steps (like attention with a decay mask), a linear recurrence on
(C, n, m) across chunks, the state in float32.  PyTorch runs eagerly, so
the chunks are a Python loop; when autograd records it, each chunk's
body runs under ``torch.utils.checkpoint`` (the JAX package checkpoints
the scan body), so training keeps one chunk's (L, L) intermediates at a
time instead of every chunk's.

sLSTM (scalar memory, block-diagonal recurrence R per head): a Python
loop over time with exponential-gate stabilization.  Its state is kept
head-major, (H, B, dh), inside the loop, so that the recurrent product
and the input's pre-activations are one ``baddbmm`` a step; a step is
then some 17 small launches on a card.

Everything here is plain torch, as the JAX package's xLSTM is plain jnp:
no kernel of the port is on this path.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Params, dense_init, gelu, randn
from .recurrent import _causal_conv

MLSTM_CHUNK = 256
M0 = -1e30               # the stabilizer's starting log-max
CUMSUM_BLOCK = 16


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg, dtype, device: torch.device
               ) -> Params:
    D = cfg.d_model
    Din = int(cfg.proj_factor_mlstm * D)
    H, W = cfg.heads, cfg.conv_width
    return {
        "w_up": dense_init(gen, D, 2 * Din, dtype, device),  # path + gate z
        "conv_w": randn(gen, (W, Din), device, dtype, W ** -0.5),
        "wq": dense_init(gen, Din, Din, dtype, device),
        "wk": dense_init(gen, Din, Din, dtype, device),
        "wv": dense_init(gen, Din, Din, dtype, device),
        "w_if": dense_init(gen, Din, 2 * H, torch.float32, device),
        "skip_scale": torch.ones((Din,), dtype=dtype, device=device),
        "w_down": dense_init(gen, Din, D, dtype, device),
    }


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, added left to right
    (``torch.cumsum`` fixes no order)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, -1)


def _block_cumsum(x: torch.Tensor, b: int = CUMSUM_BLOCK) -> torch.Tensor:
    """Inclusive prefix sum along the last axis as a two-level scan: left
    to right within blocks of ``b``, then over the blocks' totals, added
    on.  float32 error grows with b + n / b instead of n; it is also the
    order in which XLA's CPU backend sums ``jnp.cumsum``, so the within-
    chunk decays are the JAX package's bit for bit there."""
    n = x.shape[-1]
    if n <= b:
        return _seq_cumsum(x)
    nb = -(-n // b)
    xb = F.pad(x, (0, nb * b - n)).reshape(*x.shape[:-1], nb, b)
    inner = _seq_cumsum(xb)
    carry = F.pad(_seq_cumsum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + carry[..., None]).reshape(*x.shape[:-1], nb * b)[..., :n]


def _mlstm_chunk(C, n, m, qi, ki, vi, lii, csf, totf):
    """One chunk: the carry-in state (C, n, m) and the chunk's q, k, v
    (B, H, L, dh), log input gates and within-chunk cumulative log forget
    gates (B, H, L), and their total (B, H); returns (C, n, m, h)."""
    L, dh = qi.shape[-2], qi.shape[-1]
    qi, ki, vi = qi.float(), ki.float(), vi.float()
    tri = torch.ones((L, L), dtype=torch.bool, device=qi.device).tril()
    dm = (csf[..., :, None] - csf[..., None, :]) + lii[..., None, :]
    dm = dm.masked_fill(~tri, float("-inf"))
    # decay from the carry-in state to each position s: csf[s]
    m_intra = dm.amax(-1)                                   # (B,H,L)
    m_new = torch.maximum(csf + m[..., None], m_intra)      # (B,H,L)
    # inter-chunk contribution
    scale_in = torch.exp(csf + m[..., None] - m_new)
    h_inter = torch.einsum("bhld,bhde->bhle", qi, C) * scale_in[..., None]
    n_inter = torch.einsum("bhld,bhd->bhl", qi, n) * scale_in
    # intra-chunk contribution
    w = torch.exp(dm - m_new[..., None])                    # (B,H,L,L)
    scores = torch.einsum("bhld,bhtd->bhlt", qi, ki) * (dh ** -0.5)
    aw = w * scores
    h_intra = torch.einsum("bhlt,bhtd->bhld", aw, vi)
    n_intra = aw.sum(-1)
    denom = torch.maximum((n_inter + n_intra).abs(), torch.exp(-m_new)) \
        + 1e-6
    h = (h_inter + h_intra) / denom[..., None]
    # state at the chunk's end: position t contributes with decay
    # sum_{u=t+1..L} lf[u] + li[t] = (totf - csf[t]) + li[t]
    decay_to_end = totf[..., None] - csf + lii              # (B,H,L)
    m_next = torch.maximum(totf + m, decay_to_end.amax(-1))
    sc_old = torch.exp(totf + m - m_next)                   # (B,H)
    sc_new = torch.exp(decay_to_end - m_next[..., None])    # (B,H,L)
    kw = ki * sc_new[..., None]
    C2 = C * sc_old[..., None, None] \
        + torch.einsum("bhld,bhle->bhde", kw, vi) * (dh ** -0.5)
    n2 = n * sc_old[..., None] + kw.sum(2) * (dh ** -0.5)
    return C2, n2, m_next, h


def _mlstm_chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_i: torch.Tensor, log_f: torch.Tensor
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Chunkwise-parallel mLSTM core.

    q, k, v: (B, H, S, dh); log_i, log_f: (B, H, S) float32.  Returns
    h (B, H, S, dh) float32 and the final state (C, n, m)."""
    B, H, S, dh = q.shape
    L = min(MLSTM_CHUNK, S)
    if S % L:
        raise ValueError(f"sequence of {S} must be a multiple of the mLSTM "
                         f"chunk {L}")
    nc = S // L
    csum_f = _block_cumsum(log_f.reshape(B, H, nc, L))      # within-chunk
    total_f = csum_f[..., -1]                                # (B,H,nc)
    li = log_i.reshape(B, H, nc, L)
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), M0, dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, log_i, log_f))
    hs = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        args = (C, n, m, q[:, :, sl], k[:, :, sl], v[:, :, sl], li[:, :, c],
                csum_f[:, :, c], total_f[:, :, c])
        C, n, m, h = (checkpoint(_mlstm_chunk, *args, use_reentrant=False)
                      if remat else _mlstm_chunk(*args))
        hs.append(h)
    return torch.cat(hs, dim=2), (C, n, m)


def _mlstm_in(p: Params, cfg, x: torch.Tensor, conv_state=None):
    """The up projection, conv and gates shared by the sequence and the
    decode step: (path before the conv, path, its SiLU, z, q, k, v
    (B, S, Din), log_i, log_f (B, S, H) float32, the conv's state)."""
    H = cfg.heads
    Din = p["wq"].shape[0]
    up = x @ p["w_up"]
    path_pre, z = up[..., :Din], up[..., Din:]
    path, conv_state = _causal_conv(path_pre, p["conv_w"], conv_state)
    path_act = F.silu(path)
    q, k = path_act @ p["wq"], path_act @ p["wk"]
    v = path @ p["wv"]
    # the JAX package's mixed bf16 @ f32 product promotes to float32
    gates = path_act.to(p["w_if"].dtype) @ p["w_if"]         # (B,S,2H)
    log_i, f_pre = gates[..., :H].float(), gates[..., H:].float()
    return (path_pre, path_act, z, q, k, v, log_i, F.logsigmoid(f_pre),
            conv_state)


def _mlstm_out(p: Params, x: torch.Tensor, h: torch.Tensor,
               path_act: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    h = h.to(x.dtype) + path_act * p["skip_scale"]
    return (h * F.silu(z)) @ p["w_down"]


def mlstm_forward(p: Params, cfg, x: torch.Tensor,
                  return_state: bool = False):
    """x: (B, S, D).  With ``return_state``, also the state a decode
    continues from: C, n, m and the last W-1 conv inputs."""
    B, S, D = x.shape
    H = cfg.heads
    Din = p["wq"].shape[0]
    dh = Din // H
    path_pre, path_act, z, q, k, v, log_i, log_f, _ = _mlstm_in(p, cfg, x)

    def heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)

    h, (Cf, nf, mf) = _mlstm_chunk_scan(heads(q), heads(k), heads(v),
                                        log_i.transpose(1, 2),
                                        log_f.transpose(1, 2))
    out = _mlstm_out(p, x, h.transpose(1, 2).reshape(B, S, Din), path_act,
                     z)
    if not return_state:
        return out
    W = p["conv_w"].shape[0]
    conv = (path_pre[:, S - (W - 1):] if S >= W - 1 else
            F.pad(path_pre, (0, 0, W - 1 - S, 0)))
    return out, {"C": Cf, "n": nf, "m": mf, "conv": conv.clone()}


def mlstm_cache_init(cfg, batch: int, dtype, device: torch.device
                     ) -> Params:
    H = cfg.heads
    Din = int(cfg.proj_factor_mlstm * cfg.d_model)
    dh = Din // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), M0, **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, Din),
                                dtype=dtype, device=device)}


def mlstm_decode(p: Params, cfg, x: torch.Tensor, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """Single-token recurrent update. x: (B, 1, D)."""
    B = x.shape[0]
    H = cfg.heads
    Din = p["wq"].shape[0]
    dh = Din // H
    _, path_act, z, q, k, v, log_i, log_f, conv_state = _mlstm_in(
        p, cfg, x, cache["conv"])
    q, k, v = (t.reshape(B, H, dh).float() for t in (q, k, v))
    log_i, log_f = log_i[:, 0], log_f[:, 0]                  # (B, H)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(log_f + m, log_i)
    sc_old = torch.exp(log_f + m - m_new)
    sc_new = torch.exp(log_i - m_new)
    kw = k * sc_new[..., None] * (dh ** -0.5)
    C2 = C * sc_old[..., None, None] + kw[..., :, None] * v[..., None, :]
    n2 = n * sc_old[..., None] + kw
    num = torch.einsum("bhd,bhde->bhe", q, C2)
    den = torch.maximum((q * n2).sum(-1).abs(), torch.exp(-m_new)) + 1e-6
    h = (num / den[..., None]).reshape(B, 1, Din)
    return _mlstm_out(p, x, h, path_act, z), \
        {"C": C2, "n": n2, "m": m_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg, dtype, device: torch.device
               ) -> Params:
    D, H = cfg.d_model, cfg.heads
    dh = D // H
    # the FFN width rounded to a multiple of 64, as the JAX package's
    Dff = -(-int(cfg.proj_factor_slstm * D) // 64) * 64
    # head-major: the input projection emits (..., H, 4, dh)
    return {
        "w": dense_init(gen, D, 4 * D, torch.float32, device),
        "r": randn(gen, (H, 4, dh, dh), device, torch.float32, dh ** -0.5),
        "b": torch.zeros((H, 4, dh), dtype=torch.float32, device=device),
        "w_up": dense_init(gen, D, 2 * Dff, dtype, device),  # GLU FFN
        "w_down": dense_init(gen, Dff, D, dtype, device),
    }


def _slstm_step(xp: torch.Tensor, r: torch.Tensor, state):
    """One time step, head-major: xp (H, B, 4 dh) the input's
    pre-activations with the bias, r (H, dh, 4 dh) the block-diagonal
    recurrence, state (c, n, h, m) each (H, B, dh) float32."""
    c, n, h, m = state
    pre = torch.baddbmm(xp, h, r)          # recurrent contribution added
    log_i, f_pre, z_pre, o_pre = pre.chunk(4, dim=-1)
    fm = F.logsigmoid(f_pre) + m
    m2 = torch.maximum(fm, log_i)
    i_g = torch.exp(log_i - m2)
    f_g = torch.exp(fm - m2)
    c2 = torch.addcmul(f_g * c, i_g, torch.tanh(z_pre))
    n2 = torch.addcmul(i_g, f_g, n)
    h2 = torch.sigmoid(o_pre) * c2 / torch.clamp(n2, min=1e-6)
    return c2, n2, h2, m2


def _slstm_in(p: Params, cfg, x: torch.Tensor):
    """(B, S, D) -> the input's pre-activations with the bias, head-major
    and time first, (S, H, B, 4 dh) float32, and the recurrence as
    (H, dh, 4 dh): gate g of head h at columns g dh .. (g + 1) dh."""
    B, S, D = x.shape
    H = cfg.heads
    dh = D // H
    x_pre = (x @ p["w"].to(x.dtype)).float().reshape(B, S, H, 4 * dh)
    xp = x_pre.permute(1, 2, 0, 3) + p["b"].reshape(H, 1, 4 * dh)
    r = p["r"].permute(0, 2, 1, 3).reshape(H, dh, 4 * dh)
    return xp, r


def _slstm_out(p: Params, h: torch.Tensor) -> torch.Tensor:
    a, b = (h @ p["w_up"]).chunk(2, dim=-1)
    return (gelu(a) * b) @ p["w_down"]


def _head_major(cache: Params):
    return tuple(cache[k].transpose(0, 1) for k in "cnhm")


def _batch_major(state) -> Params:
    return {k: v.transpose(0, 1).contiguous() for k, v in zip("cnhm", state)}


def slstm_forward(p: Params, cfg, x: torch.Tensor,
                  return_state: bool = False):
    """Sequential loop over time. x: (B, S, D)."""
    B, S, D = x.shape
    xp, r = _slstm_in(p, cfg, x)
    state = _head_major(slstm_cache_init(cfg, B, x.device))
    hs = []
    for t in range(S):
        state = _slstm_step(xp[t], r, state)
        hs.append(state[2])
    h = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, S, D).to(x.dtype)
    out = _slstm_out(p, h)
    if return_state:
        return out, _batch_major(state)
    return out


def slstm_cache_init(cfg, batch: int, device: torch.device) -> Params:
    H = cfg.heads
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "h": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H, dh), M0, **f32)}


def slstm_decode(p: Params, cfg, x: torch.Tensor, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """Single-token update. x: (B, 1, D)."""
    B = x.shape[0]
    xp, r = _slstm_in(p, cfg, x)
    state = _slstm_step(xp[0], r, _head_major(cache))
    h = state[2].transpose(0, 1).reshape(B, 1, cfg.d_model).to(x.dtype)
    return _slstm_out(p, h), _batch_major(state)
