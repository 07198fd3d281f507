"""Sampler backends for the work-exchange Monte-Carlo engine (port).

The reference registers ``numpy`` (exact), ``jax`` (jitted fluid
relaxation) and ``pallas`` (the fused ``we_rounds`` kernel).  The port
registers a counterpart of each:

``numpy``
    The exact integer-unit engine (largest-remainder assignments, exact
    ``Generator.gamma`` / ``Generator.binomial`` draws), the port's own
    copy of the reference's: from the same Generator it draws in the same
    order and returns the same bits.  It runs on the host whatever the
    ``device``, and is the oracle the other backends are held against.

``torch``
    The role of ``jax``: the fluid relaxation -- real-valued proportional
    shares, the mean-exact Marsaglia-Tsang Gamma with the small-shape
    boost, the per-trial argmin, the normal-limit Binomial, the online
    estimate -- as a loop of torch ops over exchange rounds on the device
    (``repro_torch.core.fluid``), its variates from a ``torch.Generator``
    there.  Like the reference's engine it consumes one
    ``rng.integers(2**63 - 1)`` draw per call, pads to the same buckets
    (rows to the ``_rows_target`` bucket of 64), and is statistically --
    not bitwise -- the reference's.  It has the coupled known/unknown
    panel and the coupled MDS sweep.

``cuda``
    The role of ``pallas``: the same fluid relaxation with counter-based
    Threefry-2x32 bits keyed per ``(trial, worker, round)``, fused into
    the hand-written CUDA kernel ``repro_torch.kernels.we_rounds`` on the
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
``device=`` (default ``"cuda"``, which raises without a card).  A backend
is selected per call (``mc(..., backend="torch")``), else by
``REPRO_SAMPLER_BACKEND``, else ``cuda``; ``numpy`` is the caller's
explicit choice of the exact host engine, never a fallback.

Inside ``grid_sharding(devices)`` the ``torch`` and ``cuda`` grid calls
split their rows over several devices, one independent stream per shard
(the reference's ``shard_map`` executor); one device is a no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, List, Literal, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .assignment import (capped_proportional_assignment_batch,
                         largest_remainder_round_batch)
from .registry import Registry
from .types import ExchangeConfig

ENV_VAR = "REPRO_SAMPLER_BACKEND"
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
    """``backend``, else ``$REPRO_SAMPLER_BACKEND``, else the ``cuda``
    default; an unknown name -- a reference name such as ``jax`` or
    ``pallas`` too -- raises a ``KeyError`` listing the registered
    backends (schemes that never draw through a backend still validate
    it)."""
    name = backend or os.environ.get(ENV_VAR) or DEFAULT_BACKEND
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
# multi-device grid sharding (the experiment layer's device axis)
# ---------------------------------------------------------------------------

_GRID_MESH: List[Optional[Tuple[torch.device, ...]]] = [None]


def grid_devices(devices=None, device=DEFAULT_DEVICE
                 ) -> Tuple[torch.device, ...]:
    """The shard devices ``devices`` names: a sequence of devices as
    given (one card may hold several shards), or a count -- ``None`` for
    every card -- of ``device``'s type: that many shards of the CPU, or
    at most ``torch.cuda.device_count()`` cards counted round from
    ``device``'s card, so shard 0 sits on the card the caller named."""
    dev = resolve_device(device)
    if devices is not None and not isinstance(devices, (int, np.integer)):
        mesh = tuple(resolve_device(d) for d in devices)
        if not mesh:
            raise ValueError("grid_sharding needs at least one device")
        return mesh
    if dev.type == "cpu":
        return (dev,) * max(1, int(devices or 1))
    have = torch.cuda.device_count()
    first = dev.index or 0
    if first >= have:
        raise ValueError(f"device={str(dev)!r} but torch sees {have} "
                         f"CUDA devices")
    n = have if devices is None else max(1, min(int(devices), have))
    return tuple(torch.device("cuda", (first + i) % have) for i in range(n))


@contextlib.contextmanager
def grid_sharding(devices=None, device=DEFAULT_DEVICE):
    """Split backend grid calls' rows over devices inside the context.

    ``devices`` as ``grid_devices`` takes it.  The ``torch`` and ``cuda``
    ``work_exchange_grid`` calls (and the ``cuda`` panel, whose stacked
    rows carry their flags) cut their padded rows into ``D`` contiguous
    blocks of ``ceil(B / D)`` and run each on its own device with its own
    stream -- no collectives.  ``numpy`` is untouched: it stays the exact
    single-device oracle.  With one device the context is a no-op, so
    callers can wrap unconditionally.  Yields the device tuple."""
    mesh = grid_devices(devices, device)
    prev = _GRID_MESH[0]
    _GRID_MESH[0] = mesh if len(mesh) > 1 else None
    try:
        yield mesh
    finally:
        _GRID_MESH[0] = prev


def active_grid_mesh() -> Optional[Tuple[torch.device, ...]]:
    """The shard devices installed by ``grid_sharding``, or None."""
    return _GRID_MESH[0]


def run_shards(fn: Callable, mesh: Sequence[torch.device],
               args: Sequence[tuple]) -> list:
    """``[fn(dev, *a) for dev, a in zip(mesh, args)]``, the shards in
    turn, each under its card's device guard (a kernel launches on the
    current device)."""
    out = []
    for d, a in zip(mesh, args):
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            out.append(fn(d, *a))
    return out


def shard_bounds(B: int, D: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` row blocks of a ``D``-way split of ``B`` rows
    padded to a multiple of ``D``: ``ceil(B / D)`` rows a shard, the
    layout of the reference's sharded run on the CPU."""
    per = -(-B // D)
    return [(d * per, (d + 1) * per) for d in range(D)]


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


def grid_bucket_shape(G: int, trials: int, K: int,
                      R: Optional[int] = None,
                      backend: Optional[str] = None) -> Dict[str, int]:
    """The padded ``(rows, K[, R])`` bucket a ``(G, trials, K[, R])``
    grid runs at on a fluid backend: rows to the ``_rows_target`` bucket
    (128, the kernel's tile, on ``cuda``; 64 on ``torch``), K to
    ``bucket_cols``, a drift schedule's rounds to ``bucket_rounds``."""
    bucket = 128 if resolve_backend(backend) == "cuda" else 64
    shape = {"rows": _rows_target(G * int(trials), bucket),
             "K": bucket_cols(K)}
    if R is not None:
        shape["R"] = bucket_rounds(R)
    return shape


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


def shard_devices(device) -> Tuple[torch.device, ...]:
    """The devices a grid call runs on: the active ``grid_sharding``'s,
    which must be of ``device``'s type and hold ``device`` where that
    names a card, else ``device`` alone."""
    dev = resolve_device(device)
    mesh = active_grid_mesh()
    if mesh is None:
        return (dev,)
    if any(d.type != dev.type for d in mesh) or (
            dev.index is not None and dev not in mesh):
        raise ValueError(f"grid_sharding over {[str(d) for d in mesh]} "
                         f"does not match device={str(dev)!r}")
    return mesh


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
    only seeds the Threefry key: one pair, or under ``grid_sharding`` one
    ``(D, 2)`` draw, a pair per shard, as the reference's ``pallas``
    backend draws.  Only the paper's ``carry`` storage mode exists here,
    as on the reference ``pallas`` backend."""
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
    mesh = shard_devices(device)
    seed = rng.integers(0, 2 ** 32, size=(len(mesh), 2), dtype=np.uint32)
    t, it, cm = we_rounds_grid(lam_rows, seed, n0=float(N),
                               threshold=float(threshold), cap=cap,
                               known=bool(known),
                               max_iter=int(cfg.max_iterations),
                               device=device, rate_schedule=sched_rows,
                               mesh=mesh)
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
    known); under ``grid_sharding`` one launch per shard, each flag
    travelling with its row.  Returns ``{"known": (t, it, cm), "unknown":
    ...}`` in the usual grid-major layout."""
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
    mesh = shard_devices(device)
    seed = rng.integers(0, 2 ** 32, size=(len(mesh), 2), dtype=np.uint32)
    t, it, cm = we_rounds_grid(stacked, seed, n0=float(N),
                               threshold=float(threshold), cap=cap_u,
                               known=flags,
                               max_iter=int(cfg_known.max_iterations),
                               device=device, rate_schedule=sched_rows,
                               mesh=mesh)
    return {"known": (t[:B], it[:B], cm[:B]),
            "unknown": (t[B:2 * B], it[B:2 * B], cm[B:2 * B])}


# ---------------------------------------------------------------------------
# torch backend: the fluid relaxation as torch ops (repro_torch.core.fluid)
# ---------------------------------------------------------------------------

PANEL_CHUNK_ENV = "REPRO_PANEL_CHUNK"


def _panel_chunk() -> int:
    return max(1, int(os.environ.get(PANEL_CHUNK_ENV, "4")))


def _torch_seed(rng: np.random.Generator) -> int:
    """The one draw a ``torch`` backend call takes from ``rng``, as the
    reference's ``jax`` backend takes it for its key."""
    return int(rng.integers(2 ** 63 - 1))


def _shard_seeds(seed: int, D: int) -> List[int]:
    """The generator seed of each of D shards: the one draw itself for
    one shard, else D seeds derived from it (the reference splits its key
    D ways)."""
    if D == 1:
        return [seed]
    return [int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for c in np.random.SeedSequence(seed).spawn(D)]


def work_exchange_grid_torch(lam: np.ndarray, N: int, cfg: ExchangeConfig,
                             trials: int, rng: np.random.Generator,
                             capped_mode: Literal["carry", "waterfill"]
                             = "carry",
                             rate_schedule: Optional[np.ndarray] = None,
                             device=DEFAULT_DEVICE) -> GridArrays:
    """The fluid-relaxation engine over the ``(G * trials, K)`` grid as
    torch ops on ``device`` (``fluid.run_grid``).

    The numpy ``rng`` gives one ``integers(2**63 - 1)`` draw, the seed of
    the device generator, as the reference's ``jax`` backend seeds its
    key, so schemes sharing a Generator stay on the reference's draws
    after a call.  Rows pad to the ``_rows_target`` bucket of 64, K to
    ``bucket_cols``, a drift schedule's rounds to ``bucket_rounds``.
    Under ``grid_sharding`` the padded rows (and their schedule) pad to a
    multiple of D with copies of row 0 and split into D blocks, each on
    its own device with a generator derived from the one draw.
    ``rate_schedule`` (``(G, R, K)``) drives drift as on every backend.
    Only the paper's ``carry`` storage mode exists here, as on the
    reference ``jax`` backend."""
    if capped_mode != "carry":
        raise ValueError(
            "the torch sampler backend implements the paper-faithful "
            "'carry' storage mode only; use backend='numpy' for "
            "'waterfill'")
    from .fluid import make_generator, run_grid

    dev = resolve_device(device)
    lam = _lam_rows(lam)
    G, K = lam.shape
    known = cfg.known_heterogeneity
    # threshold / cap come from the real worker count; the K bucket only
    # adds masked zero-rate columns
    threshold = cfg.threshold_frac * N / K
    cap = (np.inf if cfg.storage_cap_frac is None or known
           else float(np.ceil(cfg.storage_cap_frac * N / K)))
    lam_rows, B = _pad_rows(np.repeat(_pad_cols(lam, bucket_cols(K)),
                                      int(trials), axis=0))
    sched_rows = None
    if rate_schedule is not None:
        sched_rows = _pad_rows_like(
            _schedule_rows(rate_schedule, G, K, trials), lam_rows.shape[0])
    mesh = shard_devices(dev)
    kw = dict(n0=float(N), threshold=float(threshold), cap=float(cap),
              known=bool(known), max_iter=int(cfg.max_iterations))

    def run(shard_dev, rows, sched, shard_seed):
        def on_dev(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(shard_dev)
        cols = run_grid(on_dev(rows), on_dev(sched),
                        make_generator(shard_seed, shard_dev), **kw)
        return torch.stack(cols, 1).cpu().numpy()

    bounds = shard_bounds(lam_rows.shape[0], len(mesh))
    lam_rows = _pad_rows_like(lam_rows, bounds[-1][1])
    if sched_rows is not None:
        sched_rows = _pad_rows_like(sched_rows, bounds[-1][1])
    out = np.concatenate(run_shards(run, mesh, [
        (lam_rows[lo:hi], None if sched_rows is None else sched_rows[lo:hi],
         s) for (lo, hi), s in zip(bounds, _shard_seeds(_torch_seed(rng),
                                                         len(mesh)))]))
    out = out.astype(np.float64)[:B]
    return out[:, 0], out[:, 1], out[:, 2]


def gamma_rows_torch(shape_rows: np.ndarray, scale_rows: np.ndarray,
                     rng: np.random.Generator,
                     device=DEFAULT_DEVICE) -> np.ndarray:
    """Batched MT-transform Gammas on ``device`` (mean-exact; the boost
    chain runs only when some shape is below 3).  Compact ``(R, 1)``
    shape columns stay compact until the draw.  One ``integers(2**63 -
    1)`` draw seeds the device generator; the output is float32, a copy
    the caller owns (callers sort in place)."""
    from .fluid import gamma_mt, gamma_mt_large, make_generator

    dev = resolve_device(device)
    padded_shape, padded_scale, R = _gamma_rows_prep(shape_rows, scale_rows)
    boost = bool((padded_shape < 3.0).any())
    gen = make_generator(_torch_seed(rng), dev)
    alpha = torch.from_numpy(padded_shape).to(dev)
    scale = torch.from_numpy(padded_scale).to(dev)
    alpha = alpha.expand(torch.broadcast_shapes(alpha.shape, scale.shape))
    draw = gamma_mt if boost else gamma_mt_large
    return np.array(draw(gen, alpha, scale)[:R].cpu().numpy())


def work_exchange_panel_torch(lam: np.ndarray, N: int,
                              cfg_known: ExchangeConfig,
                              cfg_unknown: ExchangeConfig,
                              trials: int, rng: np.random.Generator,
                              rate_schedule: Optional[np.ndarray] = None,
                              device=DEFAULT_DEVICE
                              ) -> Dict[str, GridArrays]:
    """The work-exchange pair over a whole ``(G, K)`` panel in one coupled
    engine on ``device`` (``fluid.run_panel``): both schemes' rounds of a
    trial share one row and one stream (common random numbers), rounds
    run in chunks of ``$REPRO_PANEL_CHUNK`` (default 4) and the host
    compacts finished rows away between chunks.  One ``integers(2**63 -
    1)`` draw seeds the device generator.  It runs on ``device`` alone, as
    the reference's ``jax`` panel ignores a grid mesh.  Returns
    ``{"known": (t, it, cm), "unknown": ...}`` in the grid-major
    layout."""
    from .fluid import make_generator, run_panel

    _panel_pair_check(cfg_known, cfg_unknown)
    dev = resolve_device(device)
    lam = _lam_rows(lam)
    G, K = lam.shape
    threshold = cfg_known.threshold_frac * N / K
    cap_u = (np.inf if cfg_unknown.storage_cap_frac is None
             else float(np.ceil(cfg_unknown.storage_cap_frac * N / K)))
    lam_rows, B = _pad_rows(np.repeat(_pad_cols(lam, bucket_cols(K)),
                                      int(trials), axis=0))
    sched = None
    if rate_schedule is not None:
        sched = torch.from_numpy(_pad_rows_like(
            _schedule_rows(rate_schedule, G, K, trials),
            lam_rows.shape[0])).to(dev)
    gen = make_generator(_torch_seed(rng), dev)
    out = run_panel(torch.from_numpy(lam_rows).to(dev), B, sched, gen,
                    _rows_target, n0=float(N), threshold=float(threshold),
                    cap_u=float(cap_u),
                    max_iter=int(cfg_known.max_iterations),
                    chunk=_panel_chunk())
    out = out.cpu().numpy().astype(np.float64)
    return {"known": (out[:, 0], out[:, 1], out[:, 2]),
            "unknown": (out[:, 3], out[:, 4], out[:, 5])}


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
    name="torch",
    work_exchange_grid=work_exchange_grid_torch,
    description="fluid-relaxation engine as torch ops on the device (MT "
                "gamma + argmin + normal-limit binomial, float32, one "
                "torch.Generator); statistically equivalent, not "
                "bit-identical",
    gamma_rows=gamma_rows_torch,
    coupled_mds_sweep=True,
    work_exchange_panel=work_exchange_panel_torch))

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
    "ENV_VAR", "DEFAULT_BACKEND", "SAMPLER_BACKENDS", "SamplerBackend",
    "register_backend", "get_backend", "list_backends", "resolve_backend",
    "validate_backend", "get_gamma_rows", "bucket_cols", "bucket_rounds",
    "grid_bucket_shape", "grid_devices", "grid_sharding",
    "active_grid_mesh", "shard_devices", "run_shards", "shard_bounds",
    "PANEL_CHUNK_ENV",
    "work_exchange_grid_numpy", "gamma_rows_numpy",
    "work_exchange_grid_torch", "gamma_rows_torch",
    "work_exchange_panel_torch",
    "work_exchange_grid_cuda", "gamma_rows_cuda", "work_exchange_panel_cuda",
]
