"""Python binding of the hand-written CUDA ``we_rounds`` kernel.

The source is ``src/repro_torch/csrc/we_rounds.cu`` (the counterpart of
the Pallas ``_we_rounds_body``; its header says what bounds it and how
its one-warp-per-row design meets that).  It is built and loaded by the
shared helper ``kernels/_build.py`` (``nvcc`` for ``sm_90a`` at first
use, ``we_rounds-<hash>.so`` in ``src/repro_torch/_build/``, ``ctypes``).
Nothing here runs when the module is imported.

``we_rounds_cuda`` takes CUDA tensors only: it checks them, allocates the
output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCH_COUNTS``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import (ARCH_FLAGS, BUILD_DIR, LAUNCH_COUNTS, SHARED_FLAGS,
                      CudaLibrary, check_launch, check_tensor,
                      reset_launch_counts, stream_of)

NVCC_FLAGS = (*ARCH_FLAGS, "--fmad=false", *SHARED_FLAGS)
MAX_K = 256
LIBRARY = CudaLibrary(
    "we_rounds", NVCC_FLAGS, "we_rounds_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 2
    + [ctypes.c_float] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

__all__ = ["BUILD_DIR", "LAUNCH_COUNTS", "LIBRARY", "MAX_K", "library_path",
           "reset_launch_counts", "we_rounds_cuda"]


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    return LIBRARY.library_path()


def we_rounds_cuda(lam_rows: torch.Tensor, seed,
                   sched: Optional[torch.Tensor] = None,
                   known_flags: Optional[torch.Tensor] = None, *,
                   n0: float, threshold: float, cap: float, known: bool,
                   max_iter: int) -> torch.Tensor:
    """Launch the kernel; returns a ``(B, 3)`` float32 CUDA tensor
    ``[t_comp, iterations, n_comm]``.

    ``lam_rows`` is ``(B, K)`` float32 on a CUDA device with ``K <= 256``;
    ``seed`` the Threefry key pair; ``sched`` an optional ``(B, R, K)``
    drift schedule; ``known_flags`` an optional ``(B,)`` / ``(B, 1)``
    per-row known flag (the mixed panel; ``known`` is then ignored).
    """
    if not lam_rows.is_cuda:
        raise ValueError("we_rounds_cuda takes CUDA tensors; the plain "
                         "version in ref.py serves the CPU")
    if lam_rows.dim() != 2:
        raise ValueError(f"lam_rows must be (B, K); got {tuple(lam_rows.shape)}")
    B, K = lam_rows.shape
    if K > MAX_K:
        raise ValueError(f"we_rounds_cuda supports K <= {MAX_K} workers; "
                         f"got K={K}")
    dev = lam_rows.device
    check_tensor(lam_rows, "lam_rows", (B, K), dev)
    R = 1
    if sched is not None:
        R = sched.shape[1] if sched.dim() == 3 else -1
        check_tensor(sched, "sched", (B, R, K), dev)
        if R < 1:
            raise ValueError("sched must hold at least one round")
    if known_flags is not None:
        known_flags = known_flags.reshape(B)
        check_tensor(known_flags, "known_flags", (B,), dev)
    k0, k1 = (int(s) & 0xFFFFFFFF for s in seed)
    out = torch.empty((B, 3), dtype=torch.float32, device=dev)
    rc = LIBRARY.function()(
        lam_rows.data_ptr(), None if sched is None else sched.data_ptr(),
        None if known_flags is None else known_flags.data_ptr(),
        out.data_ptr(), B, K, R, k0, k1, float(n0), float(threshold),
        float(cap), int(bool(known)), int(max_iter),
        int(float(n0) > float(threshold)), dev.index or 0,
        stream_of(lam_rows))
    check_launch("we_rounds", rc)
    return out
