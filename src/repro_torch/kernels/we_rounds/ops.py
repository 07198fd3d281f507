"""Dispatch layer for the ``we_rounds`` kernel package.

``we_rounds_grid`` is what the ``cuda`` sampler backend calls: it pads the
batch with copies of row 0 to a multiple of ``DEFAULT_BLOCK_B`` (counters
are keyed by the launch's row id, so padding never alters real rows),
moves the rows to ``device`` and dispatches by the tensor's device -- a
CUDA tensor launches the hand-written kernel, a CPU tensor runs the plain
PyTorch version.  Nothing falls back from one to the other.  Given a
``mesh`` of D devices it splits the rows into D blocks and launches once
per block, each with its own seed pair (see ``we_rounds_grid``).

``gamma_rows_grid`` (the MDS L-sweep primitive) is plain torch on the
device on both; the reference jits it as plain jnp too.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from .kernel import we_rounds_cuda
from .ref import (gamma_rows_reference, we_rounds_reference,
                  we_rounds_reference_panel)

DEFAULT_BLOCK_B = 128


def we_rounds(lam_rows: torch.Tensor, seed,
              sched: Optional[torch.Tensor] = None,
              known_flags: Optional[torch.Tensor] = None, *, n0: float,
              threshold: float, cap: float, known: bool,
              max_iter: int) -> torch.Tensor:
    """The round pipeline on tensors -> ``(B, 3)`` float32
    ``[t_comp, iterations, n_comm]`` on the input's device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(n0=n0, threshold=threshold, cap=cap, max_iter=max_iter)
    if lam_rows.is_cuda:
        return we_rounds_cuda(lam_rows, seed, sched, known_flags,
                              known=known, **kw)
    if known_flags is not None:
        cols = we_rounds_reference_panel(lam_rows, seed, known_flags, sched,
                                         **kw)
    else:
        cols = we_rounds_reference(lam_rows, seed, sched, known=known, **kw)
    return torch.stack(cols, dim=1)


def _pad_rows(rows: Optional[np.ndarray], pad: int) -> Optional[np.ndarray]:
    if rows is None or pad == 0:
        return rows
    return np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])


def we_rounds_grid(lam_rows: np.ndarray, seed, *, n0: float,
                   threshold: float, cap: float, known, max_iter: int,
                   device=DEFAULT_DEVICE,
                   rate_schedule: Optional[np.ndarray] = None,
                   mesh: Optional[Sequence[torch.device]] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused round pipeline over ``(B, K)`` rate rows -> per-row
    ``(t_comp, iterations, n_comm)`` float64 numpy arrays.

    ``seed`` is a pair of uint32 (any sequence of two ints).  ``known`` is
    a bool (the single-scheme path) or a ``(B,)`` per-row flag array --
    the fused-panel mixed mode (``cap`` applies to the unknown rows; known
    rows are uncapped).  ``rate_schedule`` (optional ``(B, R, K)``,
    row-aligned with ``lam_rows``) is the drifting-scenario per-round
    schedule.

    ``mesh`` (D devices, from ``grid_sharding``) splits the rows: padded
    with copies of row 0 to a multiple of D, cut into D blocks of
    ``ceil(B / D)`` rows, and block ``d`` launched on ``mesh[d]`` with
    seed row ``d`` of a ``(D, 2)`` ``seed`` and its own row counters from
    0 -- the layout of the reference's sharded run on the CPU, so the
    rows agree with it as the unsplit rows do.  Every block is launched
    before any is read back.
    """
    dev = resolve_device(device)
    lam_rows = np.asarray(lam_rows, dtype=np.float32)
    if lam_rows.ndim != 2:
        raise ValueError(f"lam_rows must be (B, K); got {lam_rows.shape}")
    B = lam_rows.shape[0]
    sched = None
    if rate_schedule is not None:
        sched = np.asarray(rate_schedule, dtype=np.float32)
        if sched.ndim != 3 or sched.shape[0] != B:
            raise ValueError(f"rate_schedule must be (B={B}, R, K); "
                             f"got {sched.shape}")
    flags = None
    if not isinstance(known, (bool, np.bool_)):
        flags = np.asarray(known, dtype=np.float32).reshape(-1)
        if flags.shape[0] != B:
            raise ValueError(f"per-row known flags must have one entry per "
                             f"row (B={B}); got {flags.shape[0]}")
        known = False
    kw = dict(n0=float(n0), threshold=float(threshold), cap=float(cap),
              known=bool(known), max_iter=int(max_iter))
    mesh = (dev,) if mesh is None else tuple(mesh)
    D = len(mesh)
    seeds = np.asarray(seed, dtype=np.uint32).reshape(D, 2)
    per = -(-B // D)
    lam_rows, sched, flags = (_pad_rows(a, D * per - B)
                              for a in (lam_rows, sched, flags))
    outs = []
    for d, shard_dev in enumerate(mesh):
        lo, hi = d * per, (d + 1) * per
        pad = (-per) % DEFAULT_BLOCK_B
        part = [None if a is None else
                torch.from_numpy(_pad_rows(a[lo:hi], pad)).to(shard_dev)
                for a in (lam_rows, sched, flags)]
        outs.append(we_rounds(part[0], [int(s) for s in seeds[d]], part[1],
                              part[2], **kw))
    out = np.concatenate([o.cpu().numpy()[:per] for o in outs])
    out = out.astype(np.float64)[:B]
    return out[:, 0], out[:, 1], out[:, 2]


def gamma_rows_grid(shape_rows: np.ndarray, scale_rows: np.ndarray, seed,
                    device=DEFAULT_DEVICE) -> np.ndarray:
    """Counter-based ``Gamma(shape) * scale`` over ``(R, K)`` rows in one
    pass on ``device`` (shape/scale broadcast against each other).  The
    boost chain -- and its two extra Threefry calls per element -- runs
    only when some shape is below 3.  Output stays float32."""
    dev = resolve_device(device)
    shape_rows = np.asarray(shape_rows, dtype=np.float32)
    scale_rows = np.asarray(scale_rows, dtype=np.float32)
    seed_pair = [int(s) for s in np.asarray(seed, dtype=np.uint32).reshape(2)]
    boost = bool((shape_rows < 3.0).any())
    out = gamma_rows_reference(torch.from_numpy(shape_rows).to(dev),
                               torch.from_numpy(scale_rows).to(dev),
                               seed_pair, boost=boost)
    return out.cpu().numpy()
