"""Python binding of the hand-written CUDA ``we_rounds`` kernel.

The source is ``src/repro_torch/csrc/we_rounds.cu`` (the counterpart of
the Pallas ``_we_rounds_body``; its header says what bounds it and how
its one-warp-per-row design meets that).  It is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use,
into ``src/repro_torch/_build/`` (rebuilt whenever the source or the
flags change: the file name carries their hash), and loaded with
``ctypes``.  Nothing here runs when the module is imported.

``we_rounds_cuda`` takes CUDA tensors only: it checks them, allocates the
output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCH_COUNTS``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "we_rounds.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_K = 256

# launches of each hand-written kernel, counted where the launch happens
LAUNCH_COUNTS: Dict[str, int] = {"we_rounds": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{path.parent}); the we_rounds kernel is built "
                           "from source at first use")
    return str(path)


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"we_rounds-{h}.so"


def build(verbose: bool = False) -> Tuple[Path, float]:
    """Compile the kernel library if it is not built yet.  Returns the
    library path and the seconds spent compiling (0.0 when cached).
    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, end="")
    os.replace(tmp, path)       # atomic: concurrent builders never clash
    return path, seconds


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.we_rounds_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_uint32] * 2 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}; got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check(lam_rows, "lam_rows", (B, K), dev)
    R = 1
    if sched is not None:
        R = sched.shape[1] if sched.dim() == 3 else -1
        _check(sched, "sched", (B, R, K), dev)
        if R < 1:
            raise ValueError("sched must hold at least one round")
    if known_flags is not None:
        known_flags = known_flags.reshape(B)
        _check(known_flags, "known_flags", (B,), dev)
    k0, k1 = (int(s) & 0xFFFFFFFF for s in seed)
    out = torch.empty((B, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().we_rounds_launch(
        lam_rows.data_ptr(), None if sched is None else sched.data_ptr(),
        None if known_flags is None else known_flags.data_ptr(),
        out.data_ptr(), B, K, R, k0, k1, float(n0), float(threshold),
        float(cap), int(bool(known)), int(max_iter),
        int(float(n0) > float(threshold)), dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"we_rounds launch failed: cudaError {rc}")
    LAUNCH_COUNTS["we_rounds"] += 1
    return out
