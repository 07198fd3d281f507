"""Sampler backends for the work-exchange Monte-Carlo engine (port).

The reference registers ``numpy`` (exact), ``jax`` (jitted fluid
relaxation) and ``pallas`` (the fused ``we_rounds`` kernel).  The port
registers two of their counterparts:

``numpy``
    The exact integer-unit engine (largest-remainder assignments, exact
    ``Generator.gamma`` / ``Generator.binomial`` draws), the port's own
    copy of the reference's: from the same Generator it draws in the same
    order and returns the same bits.  It runs on the host whatever the
    ``device``, and is the oracle the other backend is held against.

``cuda``
    The role of ``pallas``: the same fluid relaxation as the reference's
    transform backends -- counter-based Threefry-2x32 bits keyed per
    ``(trial, worker, round)``, the mean-exact Marsaglia-Tsang Gamma, the
    per-trial argmin, the normal-limit Binomial -- fused into the
    hand-written CUDA kernel ``repro_torch.kernels.we_rounds`` on the
    card, and its plain PyTorch version for tensors on the CPU.  It
    consumes the numpy ``Generator`` exactly as the reference ``pallas``
    backend does (one ``rng.integers(0, 2**32, size=2)`` draw per engine
    call) and pads to the same shape buckets (rows to the ``_rows_target``
    bucket of 128, K to ``bucket_cols``, R to ``bucket_rounds``), so both
    packages key the same Threefry counters from the same Generator and
    agree row by row to float tolerance.

The grid contract returns flat per-run arrays ``(t_comp, iterations,
n_comm)`` of length ``G * trials`` in grid-major order.  Every backend
call takes ``capped_mode`` (only ``numpy`` has ``"waterfill"``) and
``device=`` (default ``"cuda"``, which raises without a card).  Backends
are selected per call (``mc(..., backend="numpy")``); ``cuda`` is the
default, and ``numpy`` is the caller's explicit choice of the exact host
engine, never a fallback.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Literal, Optional, Tuple

import numpy as np

from ..device import DEFAULT_DEVICE
from .assignment import (capped_proportional_assignment_batch,
                         largest_remainder_round_batch)
from .registry import Registry
from .types import ExchangeConfig

DEFAULT_BACKEND = "cuda"

# (t_comp, iterations, n_comm), each shape (G * trials,), grid-major
GridArrays = Tuple[np.ndarray, np.ndarray, np.ndarray]
# (lam (G, K), N, cfg, trials, rng, capped_mode="carry",
#  rate_schedule=None, device=...)
WEGridFn = Callable[..., GridArrays]
# (shape_rows, scale_rows, rng, device=...) -> (R, K) Gamma(shape) * scale
GammaRowsFn = Callable[..., np.ndarray]


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplerBackend:
    """One RNG/compute backend behind the work-exchange MC pipeline.

    ``gamma_rows`` is the batched order-statistic primitive the MDS
    L-sweep draws through.  ``work_exchange_panel`` (``None`` where the
    backend has none: the pair then runs as two grid calls) runs the
    known/unknown work-exchange pair of a whole panel in one engine call:
    ``(lam (G, K), N, cfg_known, cfg_unknown, trials, rng,
    rate_schedule=None, device=...) -> {"known": GridArrays, "unknown":
    GridArrays}``.  ``coupled_mds_sweep`` marks the common-random-numbers
    L-sweep (candidate Erlangs built as cumulative Gamma increments over
    one shared trial axis), the sweep of the reference's transform
    backends; exact backends leave it False and sweep every candidate
    on independent draws, bit for bit the per-L loop.
    """

    name: str
    work_exchange_grid: WEGridFn
    gamma_rows: GammaRowsFn
    work_exchange_panel: Optional[Callable] = None
    description: str = ""
    coupled_mds_sweep: bool = False


SAMPLER_BACKENDS: Registry[SamplerBackend] = Registry("sampler backend")


def register_backend(backend: SamplerBackend) -> None:
    SAMPLER_BACKENDS.register(backend.name, backend)


def list_backends() -> List[str]:
    return SAMPLER_BACKENDS.names()


def get_backend(name: str) -> SamplerBackend:
    return SAMPLER_BACKENDS.get(name)


def validate_backend(backend: Optional[str] = None) -> str:
    """``backend`` or the ``cuda`` default; an unknown name raises a
    ``KeyError`` listing the registered backends (schemes that never draw
    through a backend still validate it)."""
    name = backend or DEFAULT_BACKEND
    get_backend(name)
    return name


# every registered backend of the port runs wherever torch does (the
# device, not the backend, is what may be missing), so resolving a name
# is validating it
resolve_backend = validate_backend


def get_gamma_rows(name: str) -> GammaRowsFn:
    """The backend's batched Gamma-rows primitive."""
    return get_backend(name).gamma_rows


# ---------------------------------------------------------------------------
# shape buckets (shared with the reference so counters line up)
# ---------------------------------------------------------------------------

def _rows_target(R: int, bucket: int = 64) -> int:
    """Batch-axis bucket: power-of-two (>= ``bucket``) up to 8192 rows,
    multiples of 8192 above."""
    if R > 8192:
        return -(-R // 8192) * 8192
    return max(bucket, 1 << (R - 1).bit_length())


def bucket_cols(K: int) -> int:
    """Worker-axis (K) shape bucket: power-of-two up to 16 workers, then
    the next multiple of 8.  Padded columns carry ``lambda = 0`` and are
    fully masked (never busy, never assigned, estimator prior 0).  The
    Threefry counters are keyed by the padded K, so the port keeps the
    reference's (default) buckets."""
    if K <= 16:
        return 1 << max(K - 1, 0).bit_length()
    return -(-K // 8) * 8


def bucket_rounds(R: int) -> int:
    """Drift-schedule round-axis (R) bucket: power-of-two up to 16
    rounds, then the next multiple of 16.  Padding repeats the last
    schedule row, which is exactly the engines' round >= R clamp."""
    if R <= 16:
        return 1 << max(R - 1, 0).bit_length()
    return -(-R // 16) * 16


def _pad_rows(rows: np.ndarray, bucket: int = 64) -> Tuple[np.ndarray, int]:
    """Pad the leading axis to its ``_rows_target`` bucket with copies of
    row 0.  Returns ``(padded, original_length)``."""
    R = rows.shape[0]
    target = _rows_target(R, bucket)
    if target - R:
        rows = np.concatenate([rows, np.repeat(rows[:1], target - R,
                                               axis=0)])
    return rows, R


def _pad_cols(rows: np.ndarray, Kb: int) -> np.ndarray:
    """Zero-pad the trailing worker axis to the ``Kb`` bucket (masked
    columns: rate 0 means never busy, never assigned)."""
    K = rows.shape[-1]
    if Kb > K:
        rows = np.pad(rows, [(0, 0)] * (rows.ndim - 1) + [(0, Kb - K)])
    return rows


def _pad_sched(sched: np.ndarray, Rb: int, Kb: int) -> np.ndarray:
    """Bucket-pad a ``(..., R, K)`` rate schedule: zero columns on the
    worker axis (masked), last-row repeats on the round axis."""
    R, K = sched.shape[-2], sched.shape[-1]
    if Kb > K:
        sched = _pad_cols(sched, Kb)
    if Rb > R:
        sched = np.concatenate(
            [sched, np.repeat(sched[..., -1:, :], Rb - R, axis=-2)],
            axis=-2)
    return sched


def _pad_rows_like(rows: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading axis to an already-chosen target length with
    copies of row 0 (schedule rows stay aligned with the rate rows)."""
    extra = target - rows.shape[0]
    if extra > 0:
        rows = np.concatenate([rows, np.repeat(rows[:1], extra, axis=0)])
    return rows


def _pad_rows_to(rows: np.ndarray, R: int) -> np.ndarray:
    """Bucket-pad 2-D arrays whose leading axis carries the ``R``
    broadcast rows; leave size-1 leading axes and 1-D ``(K,)`` vectors
    (both pure-broadcast operands) untouched."""
    if rows.ndim == 2 and rows.shape[0] == R and R > 1:
        return _pad_rows(rows)[0]
    return rows


def _gamma_rows_prep(shape_rows: np.ndarray, scale_rows: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """gamma_rows prologue: float32 conversion, broadcast-shape
    validation and bucket padding of the row-carrying operands.  Returns
    ``(shape, scale, R)``."""
    shape_rows = np.asarray(shape_rows, dtype=np.float32)
    scale_rows = np.asarray(scale_rows, dtype=np.float32)
    out_shape = np.broadcast_shapes(shape_rows.shape, scale_rows.shape)
    if len(out_shape) != 2:
        raise ValueError(f"shape/scale rows must broadcast to (R, K); "
                         f"got {out_shape}")
    R = out_shape[0]
    return (_pad_rows_to(shape_rows, R),
            _pad_rows_to(np.ascontiguousarray(scale_rows), R), R)


def _schedule_rows(rate_schedule: np.ndarray, G: int, K: int,
                   trials: int) -> np.ndarray:
    """Validate a ``(G, R, K)`` schedule, bucket-pad it and repeat it per
    trial: ``(G * trials, Rb, Kb)`` rows aligned with the rate rows."""
    sched = np.asarray(rate_schedule, dtype=np.float32)
    if sched.ndim != 3 or sched.shape[0] != G or sched.shape[2] != K:
        raise ValueError(f"rate_schedule must be (G={G}, R, K={K}); "
                         f"got shape {sched.shape}")
    sched = _pad_sched(sched, bucket_rounds(sched.shape[1]), bucket_cols(K))
    return np.repeat(sched, int(trials), axis=0)


def _lam_rows(lam: np.ndarray) -> np.ndarray:
    lam = np.asarray(lam, dtype=np.float32)
    if lam.ndim != 2:
        raise ValueError(f"lam must be (G, K); got shape {lam.shape}")
    return lam


# ---------------------------------------------------------------------------
# numpy backend: exact integer-unit engine, generalized to per-row rates
# ---------------------------------------------------------------------------

def work_exchange_grid_numpy(lam: np.ndarray, N: int, cfg: ExchangeConfig,
                             trials: int, rng: np.random.Generator,
                             capped_mode: Literal["carry", "waterfill"]
                             = "carry",
                             rate_schedule: Optional[np.ndarray] = None,
                             device=DEFAULT_DEVICE) -> GridArrays:
    """Exact batched engine over a ``(G, K)`` heterogeneity grid, on the
    host whatever ``device`` names (the caller has resolved it).

    Every row of the ``(G * trials, K)`` state is one independent run of
    Algorithm 1/3; rows are grid-major (``g * trials + t``).  With
    ``G == 1`` the randomness is consumed in exactly the order of the
    reference's trial-batched engine (and hence, at ``trials == 1``, of
    the scalar reference) -- the bit-identity the tests pin down.

    ``rate_schedule`` (optional, ``(G, R, K)``) drives scenario drift:
    the service draws of exchange round ``r`` use row ``min(r, R - 1)``
    of the point's schedule while the *assignment* keeps using the
    nominal ``lam`` (known) or the online estimate (unknown), exactly
    the scheduler-sees-nominal / reality-drifts split of the drifting
    and trace-corpus scenario families.  With ``rate_schedule=None``
    this path is byte-for-byte the stationary engine.
    """
    lam = np.asarray(lam, dtype=np.float64)
    if lam.ndim != 2:
        raise ValueError(f"lam must be (G, K); got shape {lam.shape}")
    G, K = lam.shape
    T = int(trials)
    B = G * T
    known = cfg.known_heterogeneity
    threshold = cfg.threshold_frac * N / K
    cap = (np.inf if cfg.storage_cap_frac is None or known
           else int(np.ceil(cfg.storage_cap_frac * N / K)))
    lam_rows = np.repeat(lam, T, axis=0)          # (B, K), grid-major
    inv_lam = 1.0 / lam_rows
    inv_sched = None
    if rate_schedule is not None:
        sched = np.asarray(rate_schedule, dtype=np.float64)
        if sched.ndim != 3 or sched.shape[0] != G or sched.shape[2] != K:
            raise ValueError(f"rate_schedule must be (G={G}, R, K={K}); "
                             f"got shape {sched.shape}")
        inv_sched = 1.0 / np.repeat(sched, T, axis=0)   # (B, R, K)

    est_done = np.zeros((B, K))
    est_time = np.zeros(B)
    lam_hat = np.ones((B, K))
    n_rem = np.full(B, N, dtype=np.int64)
    n_left_prev = np.zeros((B, K), dtype=np.int64)
    n_done = np.zeros((B, K), dtype=np.int64)
    t_comp = np.zeros(B)
    n_comm = np.zeros(B)
    iters = np.zeros(B, dtype=np.int64)
    in_loop = np.ones(B, dtype=bool)

    while True:
        # compact every pass to the runs still above the threshold; row
        # order is ascending, so a lone run draws in exactly the scalar
        # order and the tail of long-running runs stays cheap
        in_loop &= (n_rem > threshold) & (iters < cfg.max_iterations)
        idx = np.flatnonzero(in_loop)
        if idx.size == 0:
            break
        n = idx.size
        rates = lam_rows[idx] if known else lam_hat[idx]
        rem = n_rem[idx]
        if np.isinf(cap):
            assign = largest_remainder_round_batch(rates, rem)
        elif capped_mode == "waterfill":
            assign = capped_proportional_assignment_batch(rates, rem, cap)
        else:
            assign = np.minimum(largest_remainder_round_batch(rates, rem),
                                cap)
        assigned = assign.sum(axis=1)
        carried = rem - assigned
        # degenerate rounding: that run leaves the loop without drawing
        live = assigned > 0
        if not live.all():
            in_loop[idx[~live]] = False
            idx, assign, carried = idx[live], assign[live], carried[live]
            n = idx.size
            if n == 0:
                break

        started = iters[idx] > 0
        comm_add = np.maximum(assign - n_left_prev[idx], 0).sum(axis=1)
        n_comm[idx] += np.where(started, comm_add, 0.0)

        # batched iteration outcome (same draw order as the scalar path)
        if inv_sched is None:
            scale = inv_lam[idx]
        else:        # service rates of THIS round (clamped to the last row)
            r_idx = np.minimum(iters[idx], inv_sched.shape[1] - 1)
            scale = inv_sched[idx, r_idx]
        busy = assign > 0
        if busy.all():      # the common case: draw the full matrix directly
            t_k = rng.gamma(shape=assign, scale=scale)
        else:
            t_k = np.full((n, K), np.inf)
            t_k[busy] = rng.gamma(shape=assign[busy], scale=scale[busy])
        finisher = np.argmin(t_k, axis=1)
        rows = np.arange(n)
        t_star = t_k[rows, finisher]
        done = np.zeros((n, K), dtype=np.int64)
        done[rows, finisher] = assign[rows, finisher]
        others = busy.copy()
        others[rows, finisher] = False
        o_rows, o_cols = np.nonzero(others)      # C order == scalar draw order
        if o_rows.size:
            n_oth = np.maximum(assign[o_rows, o_cols] - 1, 0)
            p_oth = np.clip(t_star[o_rows] / t_k[o_rows, o_cols], 0.0, 1.0)
            done[o_rows, o_cols] = rng.binomial(n_oth, p_oth)

        iters[idx] += 1
        t_comp[idx] += t_star
        n_done[idx] += done
        leftover = assign - done
        n_left_prev[idx] = leftover
        n_rem[idx] = carried + leftover.sum(axis=1)
        if not known:        # online estimate, eq. (23)
            ed = est_done[idx] + done
            et = est_time[idx] + t_star
            est_done[idx] = ed
            est_time[idx] = et
            lam_hat[idx] = np.where(ed > 0,
                                    ed / np.maximum(et, 1e-300)[:, None], 1.0)

    # final phase below the threshold: assign the remainder, wait for all
    idx = np.flatnonzero(n_rem > 0)
    if idx.size:
        n = idx.size
        rates = lam_rows[idx] if known else lam_hat[idx]
        assign = largest_remainder_round_batch(rates, n_rem[idx])
        comm_add = np.maximum(assign - n_left_prev[idx], 0).sum(axis=1)
        n_comm[idx] += np.where(iters[idx] > 0, comm_add, 0.0)
        if inv_sched is None:
            scale = inv_lam[idx]
        else:
            r_idx = np.minimum(iters[idx], inv_sched.shape[1] - 1)
            scale = inv_sched[idx, r_idx]
        busy = assign > 0
        if busy.all():
            t_k = rng.gamma(shape=assign, scale=scale)
        else:
            t_k = np.zeros((n, K))
            t_k[busy] = rng.gamma(shape=assign[busy], scale=scale[busy])
        t_comp[idx] += t_k.max(axis=1)
        n_done[idx] += assign
        iters[idx] += 1

    totals = n_done.sum(axis=1)
    if not (totals == N).all():
        bad = int(np.flatnonzero(totals != N)[0])
        raise AssertionError(f"work conservation violated in run {bad}: "
                             f"processed {int(totals[bad])} of {N}")
    return t_comp, iters.astype(np.float64), n_comm


def gamma_rows_numpy(shape_rows: np.ndarray, scale_rows: np.ndarray,
                     rng: np.random.Generator,
                     device=DEFAULT_DEVICE) -> np.ndarray:
    """Exact ``Generator.gamma`` over an ``(R, K)`` matrix in one call, on
    the host whatever ``device`` names.

    ``shape_rows`` and ``scale_rows`` broadcast against each other (e.g.
    an ``(R, 1)`` shape column against ``(R, K)`` scales).  With rows
    laid out L-major this consumes randomness in exactly the order of
    the per-L sweep loop ``schemes.mds_sweep`` (``Generator.gamma``
    fills the broadcast output element by element in C order whether the
    shape argument is scalar or array), which is what makes the batched
    MDS sweep bit-identical to the loop.
    """
    shape_rows = np.asarray(shape_rows, dtype=np.float64)
    out_shape = np.broadcast_shapes(shape_rows.shape,
                                    np.asarray(scale_rows).shape)
    if len(out_shape) != 2:
        raise ValueError(f"shape/scale rows must broadcast to (R, K); "
                         f"got {out_shape}")
    return rng.gamma(shape=shape_rows, scale=scale_rows)


# ---------------------------------------------------------------------------
# cuda backend: the fused we_rounds kernel (repro_torch.kernels.we_rounds)
# ---------------------------------------------------------------------------

def work_exchange_grid_cuda(lam: np.ndarray, N: int, cfg: ExchangeConfig,
                            trials: int, rng: np.random.Generator,
                            capped_mode: Literal["carry", "waterfill"]
                            = "carry",
                            rate_schedule: Optional[np.ndarray] = None,
                            device=DEFAULT_DEVICE) -> GridArrays:
    """One fused pass over the ``(G * trials, K)`` grid: the CUDA kernel
    on the card, its plain PyTorch version on the CPU.  The numpy ``rng``
    only seeds the Threefry key (one draw).  Only the paper's ``carry``
    storage mode exists here, as on the reference ``pallas`` backend."""
    if capped_mode != "carry":
        raise ValueError(
            "the cuda sampler backend implements the paper-faithful "
            "'carry' storage mode only; use backend='numpy' for "
            "'waterfill'")
    from ..kernels.we_rounds import we_rounds_grid

    lam = _lam_rows(lam)
    G, K = lam.shape
    known = cfg.known_heterogeneity
    # real-K scalars first; the K bucket only adds masked zero columns
    threshold = cfg.threshold_frac * N / K
    cap = (np.inf if cfg.storage_cap_frac is None or known
           else float(np.ceil(cfg.storage_cap_frac * N / K)))
    lam_rows = np.repeat(_pad_cols(lam, bucket_cols(K)), int(trials), axis=0)
    lam_rows, B = _pad_rows(lam_rows, bucket=128)
    sched_rows = None
    if rate_schedule is not None:
        sched_rows = _pad_rows_like(
            _schedule_rows(rate_schedule, G, K, trials), lam_rows.shape[0])
    seed = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    t, it, cm = we_rounds_grid(lam_rows, seed, n0=float(N),
                               threshold=float(threshold), cap=cap,
                               known=bool(known),
                               max_iter=int(cfg.max_iterations),
                               device=device, rate_schedule=sched_rows)
    return t[:B], it[:B], cm[:B]


def gamma_rows_cuda(shape_rows: np.ndarray, scale_rows: np.ndarray,
                    rng: np.random.Generator,
                    device=DEFAULT_DEVICE) -> np.ndarray:
    """Counter-based Threefry + MT-transform Gamma rows in one pass on
    ``device`` (``shape_rows``/``scale_rows`` broadcast)."""
    from ..kernels.we_rounds import gamma_rows_grid

    padded_shape, padded_scale, R = _gamma_rows_prep(shape_rows, scale_rows)
    seed = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    out = gamma_rows_grid(padded_shape, padded_scale, seed, device=device)
    return np.array(out[:R])      # own the memory: callers sort in place


def _panel_pair_check(cfg_known: ExchangeConfig,
                      cfg_unknown: ExchangeConfig) -> None:
    if (not cfg_known.known_heterogeneity
            or cfg_unknown.known_heterogeneity):
        raise ValueError("panel fusion takes the (known, unknown) "
                         "work-exchange config pair, in that order")
    if (cfg_known.threshold_frac != cfg_unknown.threshold_frac
            or cfg_known.max_iterations != cfg_unknown.max_iterations):
        raise ValueError("panel fusion requires the pair to share "
                         "threshold_frac and max_iterations")


def work_exchange_panel_cuda(lam: np.ndarray, N: int,
                             cfg_known: ExchangeConfig,
                             cfg_unknown: ExchangeConfig,
                             trials: int, rng: np.random.Generator,
                             rate_schedule: Optional[np.ndarray] = None,
                             device=DEFAULT_DEVICE
                             ) -> Dict[str, GridArrays]:
    """The pair as ONE ``we_rounds`` launch: known rows stacked on top of
    unknown rows with a per-row flag column (padding rows are flagged
    known).  Returns ``{"known": (t, it, cm), "unknown": ...}`` in the
    usual grid-major layout."""
    from ..kernels.we_rounds import we_rounds_grid

    _panel_pair_check(cfg_known, cfg_unknown)
    lam = _lam_rows(lam)
    G, K = lam.shape
    threshold = cfg_known.threshold_frac * N / K
    cap_u = (np.inf if cfg_unknown.storage_cap_frac is None
             else float(np.ceil(cfg_unknown.storage_cap_frac * N / K)))
    half = np.repeat(_pad_cols(lam, bucket_cols(K)), int(trials), axis=0)
    B = half.shape[0]
    stacked, _ = _pad_rows(np.concatenate([half, half]), bucket=128)
    flags = np.concatenate([np.ones(B, np.float32), np.zeros(B, np.float32),
                            np.ones(stacked.shape[0] - 2 * B, np.float32)])
    sched_rows = None
    if rate_schedule is not None:
        sched_half = _schedule_rows(rate_schedule, G, K, trials)
        sched_rows = _pad_rows_like(
            np.concatenate([sched_half, sched_half]), stacked.shape[0])
    seed = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    t, it, cm = we_rounds_grid(stacked, seed, n0=float(N),
                               threshold=float(threshold), cap=cap_u,
                               known=flags,
                               max_iter=int(cfg_known.max_iterations),
                               device=device, rate_schedule=sched_rows)
    return {"known": (t[:B], it[:B], cm[:B]),
            "unknown": (t[B:2 * B], it[B:2 * B], cm[B:2 * B])}


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

register_backend(SamplerBackend(
    name="numpy",
    work_exchange_grid=work_exchange_grid_numpy,
    description="exact integer-unit engine (Generator.gamma/binomial) on "
                "the host; bit-identical to the reference's numpy backend "
                "and to the scalar path at trials=1",
    gamma_rows=gamma_rows_numpy))

register_backend(SamplerBackend(
    name="cuda",
    work_exchange_grid=work_exchange_grid_cuda,
    description="fused we_rounds CUDA kernel (counter-based Threefry bits "
                "+ MT gamma + argmin + normal-limit binomial, one warp per "
                "trial row) on the card; its plain PyTorch version on CPU",
    gamma_rows=gamma_rows_cuda,
    coupled_mds_sweep=True,
    work_exchange_panel=work_exchange_panel_cuda))


__all__ = [
    "DEFAULT_BACKEND", "SAMPLER_BACKENDS", "SamplerBackend",
    "register_backend", "get_backend", "list_backends", "resolve_backend",
    "validate_backend", "get_gamma_rows", "bucket_cols", "bucket_rounds",
    "work_exchange_grid_numpy", "gamma_rows_numpy",
    "work_exchange_grid_cuda", "gamma_rows_cuda", "work_exchange_panel_cuda",
]
