"""The ``torch`` sampler backend's engines: the counterpart of the
reference's jitted ``jax`` backend (``repro.core.samplers``), as torch ops
on an explicit device.

The reference fuses the fluid relaxation of Algorithm 1/3 -- real-valued
proportional shares, the mean-exact Marsaglia-Tsang Gamma transform with
the small-shape boost ``Gamma(a) = Gamma(a+1) U^(1/a)``, the per-trial
argmin, the normal-limit Binomial, the online rate estimate -- into one
jitted function with a ``lax.while_loop`` over exchange rounds.  Here the
same arithmetic runs as a Python loop over rounds, every round a fixed
sequence of torch ops on ``(B, K)`` float32 tensors on the device, with
the random variates drawn from one ``torch.Generator`` on that device.

What the loop needs from the device is read in ONE device-to-host copy
per round: the round's smallest live share (the reference's ``lax.cond``
picks the Gamma tier from it: >= 3 draws one normal, >= 1 adds two boost
uniforms, below 1 three) together with ``active.any()`` (the
``while_loop``'s condition).  ``HOST_READS`` counts the rounds and the
reads, so a caller can check that ratio.

Uniforms are clamped to ``1e-12`` before their ``log``: ``torch.rand``
may return 0, where the reference draws from ``[1e-12, 1)``.

The numbers are statistically those of the reference's engine, not its
bits: the generators differ.  The padding (rows to the ``_rows_target``
bucket, K to ``bucket_cols``, drift rounds to ``bucket_rounds``) is the
caller's, as in the reference, so both engines run the same shapes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

F32 = torch.float32
INF = float("inf")
_MIN_U = 1e-12
_THIRD = 1.0 / 3.0

# rounds run and device-to-host reads made by the engines below, since the
# last reset_host_reads()
HOST_READS: Dict[str, int] = {"rounds": 0, "reads": 0}


def reset_host_reads() -> None:
    for k in HOST_READS:
        HOST_READS[k] = 0


def _read(t: torch.Tensor):
    """``t`` on the host: every device-to-host copy the engines make goes
    through here and is counted."""
    HOST_READS["reads"] += 1
    return t.cpu()


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# ---------------------------------------------------------------------------
# transform samplers
# ---------------------------------------------------------------------------

def _normal(shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=F32)


def _log_uniform(levels: int, shape, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand((levels,) + tuple(shape), generator=gen,
                   device=gen.device, dtype=F32)
    return torch.log(u.clamp_min_(_MIN_U))


def _mt(z: torch.Tensor, alpha: torch.Tensor, inv_rate) -> torch.Tensor:
    """Raw Marsaglia-Tsang transform ``d (1 + z / (3 sqrt d))^3`` with
    ``d = alpha - 1/3``: mean-exact, variance ``alpha + 1/9``, for
    ``alpha >= 3``."""
    d = alpha - _THIRD
    c = torch.clamp_min(1.0 + z / (3.0 * torch.sqrt(d)), 0.0)
    return d * c ** 3 * inv_rate


def _boosted(z: torch.Tensor, log_u: torch.Tensor, alpha: torch.Tensor,
             inv_rate) -> torch.Tensor:
    """Sub-3 shapes boosted ``levels = log_u.shape[0]`` times through the
    exact identity, so the raw transform always runs at shape
    ``alpha + levels``; the chained mean telescopes back to ``alpha``."""
    levels = log_u.shape[0]
    boost = alpha < 3.0
    a = torch.where(boost, alpha + levels, alpha)
    inv_shapes = torch.stack([1.0 / torch.clamp_min(alpha + i, 1e-12)
                              for i in range(levels)])
    pow_u = torch.exp((log_u * inv_shapes).sum(0))
    return _mt(z, a, inv_rate) * torch.where(boost, pow_u, 1.0)


def gamma_mt_large(gen: torch.Generator, alpha: torch.Tensor,
                   inv_rate) -> torch.Tensor:
    """Mean-exact for ``alpha >= 3``: one normal per element."""
    return _mt(_normal(alpha.shape, gen), alpha, inv_rate)


def gamma_mt_boost2(gen: torch.Generator, alpha: torch.Tensor,
                    inv_rate) -> torch.Tensor:
    """Mean-exact for ``alpha >= 1`` (callers mask smaller elements)."""
    z = _normal(alpha.shape, gen)
    return _boosted(z, _log_uniform(2, alpha.shape, gen), alpha, inv_rate)


def gamma_mt(gen: torch.Generator, alpha: torch.Tensor,
             inv_rate) -> torch.Tensor:
    """Mean-exact MT transform sampler for any ``alpha > 0``."""
    z = _normal(alpha.shape, gen)
    return _boosted(z, _log_uniform(3, alpha.shape, gen), alpha, inv_rate)


def _binomial(n: torch.Tensor, p: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """Binomial(n, p) in its mean/variance-exact normal limit off the
    standard normals ``z``, clipped to ``[0, n]``."""
    std = torch.sqrt(torch.clamp_min(n * p * (1.0 - p), 0.0))
    return torch.minimum(torch.clamp_min(n * p + z * std, 0.0), n)


def binomial_normal(gen: torch.Generator, n: torch.Tensor,
                    p: torch.Tensor) -> torch.Tensor:
    """Binomial(n, p) in its mean/variance-exact normal limit, clipped to
    ``[0, n]``."""
    return _binomial(n, p, _normal(n.shape, gen))


def _tiered(gen: torch.Generator, alpha: torch.Tensor, inv_rate,
            live_min: float) -> torch.Tensor:
    """The round's Gamma tier, chosen from its smallest live share: draw
    no more variates than that shape needs."""
    if live_min >= 3.0:
        return gamma_mt_large(gen, alpha, inv_rate)
    if live_min >= 1.0:
        return gamma_mt_boost2(gen, alpha, inv_rate)
    return gamma_mt(gen, alpha, inv_rate)


def _round_read(live: torch.Tensor, active: torch.Tensor
                ) -> Tuple[float, bool]:
    """The round's one host read: ``(smallest live share, any active)``."""
    live_min, any_active = _read(torch.stack(
        [live.amin(), active.any().to(F32)])).tolist()
    HOST_READS["rounds"] += 1
    return live_min, bool(any_active)


def _advance(s: Dict[str, torch.Tensor], assign: torch.Tensor,
             busy: torch.Tensor, t_raw: torch.Tensor, z: torch.Tensor,
             prior: torch.Tensor, threshold: float, max_iter: int) -> None:
    """One exchange round of one scheme on its state ``s`` (``n_rem``,
    ``n_left``, ``t_comp``, ``n_comm``, ``iters``, ``active``; updated in
    place), from the round's shares, raw service times and the binomial's
    normals ``z``.  Where ``s`` carries the online estimate (``est_done``,
    ``est_time``, ``lam_hat``: unknown rates) it is updated too."""
    t_k = torch.where(busy, t_raw, INF)
    t_star = t_k.amin(1)
    proceed = s["active"] & torch.isfinite(t_star)
    prow = proceed[:, None]
    fin = t_k == t_star[:, None]              # the finisher clears its queue
    p = torch.clamp(t_star[:, None] / t_k, 0.0, 1.0)
    done = _binomial(torch.clamp_min(assign - 1.0, 0.0), p, z)
    done = torch.where(fin, assign, torch.where(busy, done, 0.0))
    started = s["iters"] > 0
    comm = torch.clamp_min(assign - s["n_left"], 0.0).sum(1)
    s["iters"] = s["iters"] + proceed
    s["n_rem"] = torch.where(proceed, s["n_rem"] - done.sum(1), s["n_rem"])
    s["n_left"] = torch.where(prow, assign - done, s["n_left"])
    s["t_comp"] = torch.where(proceed, s["t_comp"] + t_star, s["t_comp"])
    s["n_comm"] = torch.where(
        proceed, s["n_comm"] + torch.where(started, comm, 0.0), s["n_comm"])
    s["active"] = proceed & (s["n_rem"] > threshold) & (s["iters"] < max_iter)
    if "lam_hat" in s:
        # the accumulators go unmasked: frozen rows only read them through
        # lam_hat, which is masked
        s["est_done"] = s["est_done"] + done
        s["est_time"] = s["est_time"] + t_star
        s["lam_hat"] = torch.where(prow, torch.where(
            s["est_done"] > 0.0, s["est_done"] / torch.clamp_min(
                s["est_time"], 1e-30)[:, None], prior), s["lam_hat"])


# ---------------------------------------------------------------------------
# the grid engine (one scheme over (B, K) rows)
# ---------------------------------------------------------------------------

def run_grid(lam: torch.Tensor, sched: Optional[torch.Tensor],
             gen: torch.Generator, *, n0: float, threshold: float,
             cap: float, known: bool, max_iter: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exchange rounds and the final phase over ``(B, K)`` float32
    rate rows on ``gen``'s device -> ``(t_comp, iterations, n_comm)``
    tensors there.

    ``sched`` (optional ``(B, R, K)``) drives drift: round ``r`` draws its
    service times at row ``min(r, R - 1)`` while the shares keep the
    nominal ``lam`` (known) or the online estimate (unknown).  ``known``
    selects the code path, as the reference's static argument does: the
    known path carries no estimator state.  Zero-rate columns are padding:
    never busy, never assigned (the estimate's prior is 0 there)."""
    B, K = lam.shape
    dev = lam.device
    inv_lam0 = 1.0 / lam
    lam_sum = lam.sum(1)
    prior = (lam > 0.0).to(F32)
    R = sched.shape[1] if sched is not None else 1

    n_rem = torch.full((B,), float(n0), dtype=F32, device=dev)
    s = {"n_rem": n_rem, "n_left": torch.zeros((B, K), dtype=F32, device=dev),
         "t_comp": torch.zeros(B, dtype=F32, device=dev),
         "n_comm": torch.zeros(B, dtype=F32, device=dev),
         "iters": torch.zeros(B, dtype=torch.int32, device=dev),
         "active": n_rem > threshold}
    if not known:
        s.update(est_done=torch.zeros((B, K), dtype=F32, device=dev),
                 est_time=torch.zeros(B, dtype=F32, device=dev),
                 lam_hat=prior.clone())

    rnd = 0
    while True:
        # every active row has proceeded on every earlier round, so its
        # round is the loop's counter: one schedule row for the batch
        inv_lam = (inv_lam0 if sched is None
                   else 1.0 / sched[:, min(rnd, R - 1), :])
        rates = lam if known else s["lam_hat"]
        rsum = lam_sum if known else rates.sum(1)
        assign = torch.clamp_max(rates * (s["n_rem"] / rsum)[:, None], cap)
        # "at least half a unit" is the integer engine's "assign > 0"
        busy = assign > 0.5
        live_min, any_active = _round_read(
            torch.where(busy & s["active"][:, None], assign, INF),
            s["active"])
        if not any_active:
            break
        t_raw = _tiered(gen, torch.clamp_min(assign, 0.5), inv_lam,
                        live_min)
        _advance(s, assign, busy, t_raw, _normal(assign.shape, gen), prior,
                 threshold, max_iter)
        rnd += 1

    # final phase: assign the remainder proportionally, wait for all
    n_rem, n_left, iters = s["n_rem"], s["n_left"], s["iters"]
    has_rem = n_rem > 1e-6
    rates = lam if known else s["lam_hat"]
    if sched is None:
        inv_lam = inv_lam0
    else:
        r_idx = torch.clamp_max(iters, R - 1).long()
        inv_lam = 1.0 / sched[torch.arange(B, device=dev), r_idx]
    share = rates * (n_rem / rates.sum(1))[:, None]
    comm = torch.clamp_min(share - n_left, 0.0).sum(1)
    t_k = torch.where(share > 1e-9, gamma_mt(gen, share, inv_lam), 0.0)
    t_comp = s["t_comp"] + torch.where(has_rem, t_k.amax(1), 0.0)
    n_comm = s["n_comm"] + torch.where(has_rem & (iters > 0), comm, 0.0)
    return t_comp, (iters + has_rem).to(F32), n_comm


# ---------------------------------------------------------------------------
# the coupled panel engine (the known/unknown pair on common random numbers)
# ---------------------------------------------------------------------------

_SFX = ("k", "u")
# a scheme's row state (suffixed by scheme in the panel's state) and the
# unknown member's estimate
_ROW_STATE = ("n_rem", "n_left", "t_comp", "n_comm", "iters", "active")
_ESTIMATE = ("est_done", "est_time", "lam_hat")
_NOT_FINALIZED = ("est_done", "est_time")


def _pair_gamma(gen: torch.Generator, a_k: torch.Tensor, a_u: torch.Tensor,
                inv_rate, live_min: float):
    """One raw draw -- a normal and the tier's boost uniforms --
    transformed at BOTH schemes' shapes: the common-random-numbers
    coupling.  The tier comes from the joint smallest live share, which is
    never above either scheme's own, so each marginal stays the
    per-scheme engine's."""
    z = _normal(a_k.shape, gen)
    if live_min >= 3.0:
        return _mt(z, a_k, inv_rate), _mt(z, a_u, inv_rate)
    lu = _log_uniform(2 if live_min >= 1.0 else 3, a_k.shape, gen)
    return _boosted(z, lu, a_k, inv_rate), _boosted(z, lu, a_u, inv_rate)


def _panel_stage(st: Dict[str, torch.Tensor], lam: torch.Tensor,
                 sched: Optional[torch.Tensor], gen: torch.Generator,
                 rnd: int, stop: int, threshold: float, cap_u: float,
                 max_iter: int) -> int:
    """Run rounds ``rnd .. stop - 1`` of both schemes on ``st`` (updated
    in place) while any row of either is active; returns the next round."""
    inv_lam0 = torch.where(lam > 0.0, 1.0 / lam, 0.0)
    lam_sum = lam.sum(1)
    prior = (lam > 0.0).to(F32)
    R = sched.shape[1] if sched is not None else 1
    while rnd < stop:
        inv_lam = (inv_lam0 if sched is None
                   else 1.0 / sched[:, min(rnd, R - 1), :])
        share_k = lam * (st["n_rem_k"] / lam_sum)[:, None]
        rates_u = st["lam_hat"]
        assign_u = torch.clamp_max(
            rates_u * (st["n_rem_u"] / rates_u.sum(1))[:, None], cap_u)
        busy = {"k": share_k > 0.5, "u": assign_u > 0.5}
        assign = {"k": share_k, "u": assign_u}
        live = torch.minimum(
            torch.where(busy["k"] & st["active_k"][:, None], share_k, INF),
            torch.where(busy["u"] & st["active_u"][:, None], assign_u, INF))
        live_min, any_active = _round_read(live,
                                           st["active_k"] | st["active_u"])
        if not any_active:
            break
        t_raw = dict(zip(_SFX, _pair_gamma(
            gen, torch.clamp_min(share_k, 0.5),
            torch.clamp_min(assign_u, 0.5), inv_lam, live_min)))
        z_b = _normal(lam.shape, gen)
        for sfx in _SFX:
            s = {k: st[k + "_" + sfx] for k in _ROW_STATE}
            if sfx == "u":
                s.update((k, st[k]) for k in _ESTIMATE)
            _advance(s, assign[sfx], busy[sfx], t_raw[sfx], z_b, prior,
                     threshold, max_iter)
            st.update((k if k in _ESTIMATE else k + "_" + sfx, v)
                      for k, v in s.items())
        rnd += 1
    return rnd


def _panel_final(gen: torch.Generator, lam: torch.Tensor,
                 inv: Dict[str, torch.Tensor],
                 st: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Both final phases off one shared raw draw (a normal and three boost
    uniforms, the full chain as in the per-scheme final) -> ``(rows, 6)``
    ``[t_k, it_k, cm_k, t_u, it_u, cm_u]``."""
    z = _normal(lam.shape, gen)
    lu = _log_uniform(3, lam.shape, gen)
    cols = []
    for sfx, rates in (("k", lam), ("u", st["lam_hat"])):
        n_rem = st["n_rem_" + sfx]
        has_rem = n_rem > 1e-6
        share = rates * (n_rem / rates.sum(1))[:, None]
        comm = torch.clamp_min(share - st["n_left_" + sfx], 0.0).sum(1)
        t_k = torch.where(share > 1e-9, _boosted(
            z, lu, torch.clamp_min(share, 1e-9), inv[sfx]), 0.0)
        iters = st["iters_" + sfx]
        cols += [st["t_comp_" + sfx] + torch.where(has_rem, t_k.amax(1), 0.0),
                 (iters + has_rem).to(F32),
                 st["n_comm_" + sfx] + torch.where(has_rem & (iters > 0),
                                                   comm, 0.0)]
    return torch.stack(cols, 1)


def run_panel(lam_rows: torch.Tensor, B: int, sched: Optional[torch.Tensor],
              gen: torch.Generator, rows_target, *, n0: float,
              threshold: float, cap_u: float, max_iter: int,
              chunk: int) -> torch.Tensor:
    """The work-exchange pair over ``(Bp, K)`` padded rate rows (the first
    ``B`` real) -> ``(B, 6)`` ``[t, it, cm]`` known then unknown, on
    ``gen``'s device.

    Rounds run in chunks of ``chunk``; between chunks the host reads which
    rows are still active, final-phases the finished ones and compacts the
    rest into the next ``rows_target`` bucket (at least 256 rows), so late
    rounds cost only the stragglers.  Rows move with ``index_select`` and
    results land with ``index_copy_``: no float adds whose order the
    device picks, so the same seed gives the same bits."""
    dev = lam_rows.device
    Bp, K = lam_rows.shape
    R = sched.shape[1] if sched is not None else 1
    st = {"est_done": torch.zeros((Bp, K), dtype=F32, device=dev),
          "est_time": torch.zeros(Bp, dtype=F32, device=dev),
          "lam_hat": (lam_rows > 0.0).to(F32)}
    for sfx in _SFX:
        st["n_rem_" + sfx] = torch.full((Bp,), float(n0), dtype=F32,
                                        device=dev)
        st["n_left_" + sfx] = torch.zeros((Bp, K), dtype=F32, device=dev)
        st["t_comp_" + sfx] = torch.zeros(Bp, dtype=F32, device=dev)
        st["n_comm_" + sfx] = torch.zeros(Bp, dtype=F32, device=dev)
        st["iters_" + sfx] = torch.zeros(Bp, dtype=torch.int32, device=dev)
        st["active_" + sfx] = torch.full((Bp,), float(n0) > threshold,
                                         dtype=torch.bool, device=dev)
    # idx maps state rows to panel rows (-1: compaction padding, never
    # finalized); out collects final results as rows drop out
    idx = np.concatenate([np.arange(B), np.full(Bp - B, -1)])
    out = torch.zeros((B, 6), dtype=F32, device=dev)
    lam_cur, sched_cur = lam_rows, sched

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def finalize(sub: np.ndarray) -> None:
        sub = sub[idx[sub] >= 0]
        if sub.size == 0:
            return
        n = sub.size
        gidx = on_dev(np.concatenate(
            [sub, np.repeat(sub[:1], rows_target(n) - n)]))
        st_sub = {k: v.index_select(0, gidx) for k, v in st.items()
                  if k not in _NOT_FINALIZED}
        lam_sub = lam_cur.index_select(0, gidx)
        inv = {}
        for sfx in _SFX:
            if sched_cur is None:
                r = lam_sub
            else:
                r_idx = torch.clamp_max(st_sub["iters_" + sfx], R - 1).long()
                r = sched_cur.index_select(0, gidx)[
                    torch.arange(gidx.shape[0], device=dev), r_idx]
            inv[sfx] = torch.where(r > 0.0, 1.0 / torch.clamp_min(r, 1e-30),
                                   0.0)
        res = _panel_final(gen, lam_sub, inv, st_sub)
        out.index_copy_(0, on_dev(idx[sub]), res[:n])

    rnd = r0 = 0
    while True:
        r1 = min(r0 + chunk, max_iter)
        rnd = _panel_stage(st, lam_cur, sched_cur, gen, rnd, r1, threshold,
                           cap_u, max_iter)
        r0 = r1
        act = _read(st["active_k"] | st["active_u"]).numpy()
        live = np.flatnonzero(act & (idx >= 0))
        if live.size == 0 or r0 >= max_iter:
            finalize(np.flatnonzero(idx >= 0))
            break
        tgt = max(rows_target(live.size), 256)
        if tgt < idx.size:
            finalize(np.flatnonzero(~act & (idx >= 0)))
            gather = np.concatenate([live,
                                     np.repeat(live[:1], tgt - live.size)])
            gidx = on_dev(gather)
            valid = torch.arange(tgt, device=dev) < live.size
            for k in list(st):
                st[k] = st[k].index_select(0, gidx)
            st["active_k"] = st["active_k"] & valid
            st["active_u"] = st["active_u"] & valid
            idx = np.where(np.arange(tgt) < live.size, idx[gather], -1)
            lam_cur = lam_cur.index_select(0, gidx)
            if sched_cur is not None:
                sched_cur = sched_cur.index_select(0, gidx)
    return out


__all__ = ["HOST_READS", "reset_host_reads", "make_generator",
           "gamma_mt_large", "gamma_mt_boost2", "gamma_mt",
           "binomial_normal", "run_grid", "run_panel"]
