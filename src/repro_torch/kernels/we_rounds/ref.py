"""Counter-based work-exchange round pipeline: the plain PyTorch version.

Function by function the counterpart of ``repro.kernels.we_rounds.ref``
(the JAX package's shared math + jnp oracle), on ``(rows, K)`` tensors:

* **bit generation** -- Threefry-2x32 (20 rounds), keyed per ``(trial,
  worker, round, slot)``.  Torch has no ``uint32`` add or shifts on the
  CPU, so the words live in ``int64`` tensors masked with ``& 0xFFFFFFFF``
  after every add; they equal the reference's ``uint32`` words bit for
  bit.  The CUDA kernel (``csrc/we_rounds.cu``) uses native ``uint32_t``.
* **Gamma service draws** -- the mean-exact Marsaglia-Tsang transform
  with the ``Gamma(a) = Gamma(a+1) U^(1/a)`` boost chained three times
  below shape 3.  ``c ** 3`` is written ``c * c * c`` (the reference's
  integer power is the same two products; a ``pow`` call may differ by
  an ulp).
* **straggler selection** -- per-trial argmin over the K workers.
* **Binomial done-counts** -- the mean/variance-exact normal limit.

Every operation runs in float32 in the reference's order, except that
row sums are taken in the CUDA kernel's order (``lane_sum``), so that on
the card the kernel is bitwise equal to this version.  ``log``, ``cos``,
``exp`` and ``sqrt`` differ from XLA's by an ulp or so, and XLA sums rows
in another order, so results agree with the JAX package to float
tolerance (rows where an ulp flips a discrete event -- the argmin
finisher, ``busy``, the threshold test -- excepted), not bitwise.

``we_rounds_reference`` runs the whole batch as one Python loop over
rounds; it is what the ``cuda`` backend runs for tensors on the CPU, and
what the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# slot layout per (trial, worker, round): 4 Threefry calls x 2 words
#   pair 0 -> Box-Muller pair for the Gamma normal
#   pair 1 -> boost uniforms u0, u1
#   pair 2 -> boost uniform u2 (word 1 spare)
#   pair 3 -> Box-Muller pair for the Binomial normal
N_PAIRS = 4
_MASK = 0xFFFFFFFF
# float32 constants exactly as the reference rounds them
_TWO_PI = float(np.float32(2.0 * np.pi))
_THIRD = float(np.float32(1.0 / 3.0))
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)

State = Dict[str, object]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k0, k1, c0: torch.Tensor, c1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words.

    ``k0``/``k1`` are the key words (ints); ``c0``/``c1`` broadcast
    against each other.  Returns two int64 tensors in ``[0, 2**32)``.
    """
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = (c0.to(torch.int64) + k0) & _MASK
    x1 = (c1.to(torch.int64) + k1) & _MASK
    inject = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for block in range(5):
        for d in (_ROT_A if block % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, d) ^ x0
        x0 = (x0 + inject[block][0]) & _MASK
        x1 = (x1 + (inject[block][1] + block + 1)) & _MASK
    return x0, x1


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 uniform in (0, 1): top 24 bits,
    zero-excluded so ``log(u)`` stays finite."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp_min(u, 1e-12)


def _box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def round_uniforms(k0, k1, c0: torch.Tensor, c1_base: torch.Tensor):
    """The variates one exchange round needs per ``(row, worker)`` cell.

    ``c0`` carries the global row (trial) id, ``c1_base`` the
    ``(round * K + worker) * N_PAIRS`` namespace; both broadcast over the
    tile.  Returns ``(z_gamma, u0, u1, u2, z_binom)`` float32 tensors.
    """
    a0, a1 = threefry2x32(k0, k1, c0, c1_base)
    b0, b1 = threefry2x32(k0, k1, c0, c1_base + 1)
    c0_, _ = threefry2x32(k0, k1, c0, c1_base + 2)
    d0, d1 = threefry2x32(k0, k1, c0, c1_base + 3)
    z_gamma = _box_muller(uniform01(a0), uniform01(a1))
    z_binom = _box_muller(uniform01(d0), uniform01(d1))
    return (z_gamma, uniform01(b0), uniform01(b1), uniform01(c0_), z_binom)


def gamma_mt(z: torch.Tensor, u0: torch.Tensor, u1: torch.Tensor,
             u2: torch.Tensor, alpha: torch.Tensor,
             inv_rate: torch.Tensor) -> torch.Tensor:
    """Mean-exact MT transform for any ``alpha > 0``: raw transform at
    shape ``alpha + 3`` below 3, pulled back through the exact identity
    ``Gamma(a) = Gamma(a+1) U^{1/a}`` chained three times."""
    boost = alpha < 3.0
    a = torch.where(boost, alpha + 3.0, alpha)
    d = a - _THIRD
    c = torch.clamp_min(1.0 + z / (3.0 * torch.sqrt(d)), 0.0)
    raw = d * (c * c * c) * inv_rate
    log_pow = (torch.log(u0) / torch.clamp_min(alpha, 1e-12)
               + torch.log(u1) / torch.clamp_min(alpha + 1.0, 1e-12)
               + torch.log(u2) / torch.clamp_min(alpha + 2.0, 1e-12))
    return raw * torch.where(boost, torch.exp(log_pow), 1.0)


def binomial_normal(z: torch.Tensor, n: torch.Tensor,
                    p: torch.Tensor) -> torch.Tensor:
    """Binomial(n, p) in its mean/variance-exact normal limit."""
    mean = n * p
    std = torch.sqrt(torch.clamp_min(n * p * (1.0 - p), 0.0))
    return torch.minimum(torch.clamp_min(mean + z * std, 0.0), n)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a ``(rows, K)`` float32 tensor, ``(rows, 1)``, in the
    CUDA kernel's order: 32 lanes, lane ``l`` summing columns ``l, l + 32,
    ...`` from 0 in turn, then an xor butterfly over the lanes (every lane
    ends with the same value, the halving tree below).  A library's
    reduction order is its own (and may change with the version); this one
    makes the kernel's sums bitwise equal to the plain version's."""
    rows, K = x.shape
    lanes = 32 * -(-K // 32)
    x = torch.nn.functional.pad(x, (0, lanes - K)).view(rows, -1, 32)
    s = torch.zeros((rows, 32), dtype=x.dtype, device=x.device)
    for i in range(x.shape[1]):
        s = s + x[:, i]
    for m in (16, 8, 4, 2, 1):
        s = s[:, :m] + s[:, m:2 * m]
    return s


# ---------------------------------------------------------------------------
# the round pipeline on a (rows, K) tile
# ---------------------------------------------------------------------------

def estimator_prior(lam: torch.Tensor) -> torch.Tensor:
    """Initial / no-observation rate estimate per worker column: 1 on real
    workers, 0 on zero-rate padding columns (never assigned work)."""
    return (lam > 0.0).to(torch.float32)


def init_state(rows: int, K: int, n0: float, threshold: float,
               known: bool, lam: torch.Tensor, with_round: bool = False
               ) -> State:
    dev = lam.device
    st: State = {
        "n_rem": torch.full((rows, 1), n0, dtype=torch.float32, device=dev),
        "n_left": torch.zeros((rows, K), dtype=torch.float32, device=dev),
        "t_comp": torch.zeros((rows, 1), dtype=torch.float32, device=dev),
        "n_comm": torch.zeros((rows, 1), dtype=torch.float32, device=dev),
        "iters": torch.zeros((rows, 1), dtype=torch.int64, device=dev),
        # compared in float64, as the reference compares its Python floats
        "active": torch.full((rows, 1), n0 > threshold, device=dev),
    }
    if with_round:
        # trip counter: every *active* row has proceeded on every prior
        # trip, so its ``iters`` equals this counter
        st["round"] = 0
    if not known:
        st.update(
            est_done=torch.zeros((rows, K), dtype=torch.float32, device=dev),
            est_time=torch.zeros((rows, 1), dtype=torch.float32, device=dev),
            lam_hat=estimator_prior(lam).expand(rows, K).clone())
    return st


def sched_row(sched: torch.Tensor, rnd: int) -> torch.Tensor:
    """Rates row of a ``(rows, R, K)`` schedule at round ``rnd`` (clamped
    to the last row)."""
    return sched[:, min(int(rnd), sched.shape[1] - 1), :]


def sched_inv_rates_gather(sched: torch.Tensor,
                           iters: torch.Tensor) -> torch.Tensor:
    """1/rate in effect at each row's own round ``iters`` (``(rows, 1)``)
    from a ``(rows, R, K)`` schedule; round >= R holds the last row."""
    r_idx = torch.clamp_max(iters, sched.shape[1] - 1)
    idx = r_idx[:, :, None].expand(-1, 1, sched.shape[2])
    return 1.0 / torch.gather(sched, 1, idx)[:, 0, :]


def round_body(st: State, lam: torch.Tensor, inv_lam: torch.Tensor,
               row_ids: torch.Tensor, k0, k1, *, K: int, cap: float,
               threshold: float, known: bool, max_iter: int,
               sched_at: Optional[Callable[[int], torch.Tensor]] = None,
               known_col: Optional[torch.Tensor] = None) -> State:
    """One fluid exchange round on a tile.

    The RNG round index is the row's own ``iters``, so frozen rows
    recompute already-spent counters into fully-masked lanes and the
    result does not depend on how many extra trips the loop makes.
    ``sched_at`` (drift) maps the trip counter to that round's true
    service rates; ``known_col`` (``(rows, 1)`` bool) is the fused-panel
    mixed mode, where callers pass ``known=False`` so the estimator state
    exists for every row.
    """
    worker = torch.arange(K, device=lam.device)[None, :]
    c1 = (st["iters"] * K + worker) * N_PAIRS
    z_g, u0, u1, u2, z_b = round_uniforms(k0, k1, row_ids, c1)

    if sched_at is not None:
        inv_lam = 1.0 / sched_at(st["round"])
    if known_col is not None:
        rates = torch.where(known_col, lam, st["lam_hat"])
        cap_eff = torch.where(known_col, float("inf"), float(cap))
    else:
        rates = lam if known else st["lam_hat"]
        cap_eff = torch.tensor(float(cap), dtype=torch.float32,
                               device=lam.device)
    share = rates * (st["n_rem"] / lane_sum(rates))
    assign = torch.minimum(share, cap_eff)
    busy = assign > 0.5        # sub-half slivers carry over as leftover
    t_raw = gamma_mt(z_g, u0, u1, u2, torch.clamp_min(assign, 0.5), inv_lam)
    t_k = torch.where(busy, t_raw, float("inf"))
    t_star = t_k.amin(1, keepdim=True)
    proceed = st["active"] & torch.isfinite(t_star)
    fin = t_k == t_star                     # finisher clears its queue
    p = torch.clamp(t_star / t_k, 0.0, 1.0)
    done = binomial_normal(z_b, torch.clamp_min(assign - 1.0, 0.0), p)
    done = torch.where(fin, assign, torch.where(busy, done, 0.0))
    n_rem = st["n_rem"] - lane_sum(done)

    started = st["iters"] > 0
    comm = lane_sum(torch.clamp_min(assign - st["n_left"], 0.0))

    def upd(new, old):
        return torch.where(proceed, new, old)

    iters = st["iters"] + proceed.to(torch.int64)
    n_rem_m = upd(n_rem, st["n_rem"])
    out: State = {
        "n_rem": n_rem_m,
        "n_left": upd(assign - done, st["n_left"]),
        "t_comp": upd(st["t_comp"] + t_star, st["t_comp"]),
        "n_comm": upd(st["n_comm"] + torch.where(started, comm, 0.0),
                      st["n_comm"]),
        "iters": iters,
        "active": proceed & (n_rem_m > threshold) & (iters < max_iter),
    }
    if "round" in st:
        out["round"] = st["round"] + 1
    if not known:
        # accumulators go unmasked; frozen rows only read them through
        # lam_hat, which IS masked
        ed = st["est_done"] + done
        et = st["est_time"] + t_star
        out["est_done"] = ed
        out["est_time"] = et
        out["lam_hat"] = upd(
            torch.where(ed > 0.0, ed / torch.clamp_min(et, 1e-30),
                        estimator_prior(lam)),
            st["lam_hat"])
    return out


def final_phase(st: State, lam: torch.Tensor, inv_lam: torch.Tensor,
                row_ids: torch.Tensor, k0, k1, *, K: int, known: bool,
                max_iter: int, sched: Optional[torch.Tensor] = None,
                known_col: Optional[torch.Tensor] = None):
    """Below the threshold: assign the remainder, wait for all workers.
    Uses the reserved round index ``max_iter`` (in-loop draws happen at
    ``iters < max_iter``).  Returns ``(t_comp, iters, n_comm)`` as
    ``(rows,)`` float32 tensors."""
    worker = torch.arange(K, device=lam.device)[None, :]
    c1 = (max_iter * K + worker) * N_PAIRS
    z_g, u0, u1, u2, _ = round_uniforms(k0, k1, row_ids, c1)
    has_rem = st["n_rem"] > 1e-6
    if sched is not None:
        inv_lam = sched_inv_rates_gather(sched, st["iters"])
    if known_col is not None:
        rates = torch.where(known_col, lam, st["lam_hat"])
    else:
        rates = lam if known else st["lam_hat"]
    share = rates * (st["n_rem"] / lane_sum(rates))
    comm = lane_sum(torch.clamp_min(share - st["n_left"], 0.0))
    t_k = torch.where(share > 1e-9,
                      gamma_mt(z_g, u0, u1, u2, torch.clamp_min(share, 1e-9),
                               inv_lam), 0.0)
    t_comp = st["t_comp"] + torch.where(has_rem, t_k.amax(1, keepdim=True),
                                        0.0)
    n_comm = st["n_comm"] + torch.where(has_rem & (st["iters"] > 0), comm,
                                        0.0)
    iters = st["iters"] + has_rem.to(torch.int64)
    return t_comp[:, 0], iters[:, 0].to(torch.float32), n_comm[:, 0]


# ---------------------------------------------------------------------------
# full-batch plain version (the cuda backend's CPU execution path)
# ---------------------------------------------------------------------------

def _run(lam_rows: torch.Tensor, seed, sched: Optional[torch.Tensor],
         known_col: Optional[torch.Tensor], *, n0: float, threshold: float,
         cap: float, known: bool, max_iter: int):
    B, K = lam_rows.shape
    lam = lam_rows.to(torch.float32)
    inv_lam = 1.0 / lam
    k0, k1 = (int(s) for s in seed)
    row_ids = torch.arange(B, device=lam.device)[:, None]
    sched_at = None if sched is None else (lambda r: sched_row(sched, r))
    st = init_state(B, K, n0, threshold, known, lam,
                    with_round=sched is not None)
    while bool(st["active"].any()):
        st = round_body(st, lam, inv_lam, row_ids, k0, k1, K=K, cap=cap,
                        threshold=threshold, known=known, max_iter=max_iter,
                        sched_at=sched_at, known_col=known_col)
    return final_phase(st, lam, inv_lam, row_ids, k0, k1, K=K, known=known,
                       max_iter=max_iter, sched=sched, known_col=known_col)


def we_rounds_reference(lam_rows: torch.Tensor, seed,
                        sched: Optional[torch.Tensor] = None, *,
                        n0: float, threshold: float, cap: float,
                        known: bool, max_iter: int):
    """The whole ``(B, K)`` batch, one Python loop over rounds.

    ``seed`` is the Threefry key pair (two ints); ``sched`` (optional
    ``(B, R, K)``) is the drifting scenarios' per-round rate schedule.
    Returns ``(t_comp, iterations, n_comm)`` as ``(B,)`` float32 tensors.
    """
    return _run(lam_rows, seed, sched, None, n0=n0, threshold=threshold,
                cap=cap, known=known, max_iter=max_iter)


def we_rounds_reference_panel(lam_rows: torch.Tensor, seed,
                              known_flags: torch.Tensor,
                              sched: Optional[torch.Tensor] = None, *,
                              n0: float, threshold: float, cap: float,
                              max_iter: int):
    """``we_rounds_reference`` with a per-row known-heterogeneity flag
    (``(B,)`` or ``(B, 1)``, nonzero = known): the fused-panel path, where
    known and unknown rows of a whole figure share one batch."""
    B = lam_rows.shape[0]
    known_col = known_flags.reshape(B, 1) > 0
    return _run(lam_rows, seed, sched, known_col, n0=n0, threshold=threshold,
                cap=cap, known=False, max_iter=max_iter)


# ---------------------------------------------------------------------------
# batched Gamma rows (the MDS L-sweep primitive)
# ---------------------------------------------------------------------------

def gamma_rows_reference(shape_rows: torch.Tensor, scale_rows: torch.Tensor,
                         seed, *, boost: bool = True) -> torch.Tensor:
    """Counter-based ``Gamma(shape) * scale`` over an ``(R, K)`` matrix in
    one pass (round namespace 0 -- each call gets a fresh seed).
    ``shape_rows``/``scale_rows`` broadcast against each other.  With
    ``boost=False`` (every shape >= 3, the MDS regime) only the Box-Muller
    pair is generated."""
    R, K = torch.broadcast_shapes(shape_rows.shape, scale_rows.shape)
    k0, k1 = (int(s) for s in seed)
    dev = shape_rows.device
    c0 = torch.arange(R, device=dev)[:, None]
    c1 = (torch.arange(K, device=dev) * N_PAIRS)[None, :]
    a0, a1 = threefry2x32(k0, k1, c0, c1)
    z = _box_muller(uniform01(a0), uniform01(a1))
    alpha = shape_rows.to(torch.float32).expand(R, K)
    scale = scale_rows.to(torch.float32)
    if not boost:
        d = alpha - _THIRD
        c = torch.clamp_min(1.0 + z / (3.0 * torch.sqrt(d)), 0.0)
        return d * (c * c * c) * scale
    b0, b1 = threefry2x32(k0, k1, c0, c1 + 1)
    c0_, _ = threefry2x32(k0, k1, c0, c1 + 2)
    return gamma_mt(z, uniform01(b0), uniform01(b1), uniform01(c0_),
                    alpha, scale)
