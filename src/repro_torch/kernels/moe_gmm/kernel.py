"""Python binding of the hand-written CUDA ``expert_matmul`` kernel.

The source is ``src/repro_torch/csrc/expert_matmul.cu`` (the counterpart
of the Pallas ``_gmm_kernel``; its header says what bounds it at the
serving shapes and how its design meets that).  It is built and loaded by
``kernels/_build.py`` at first use; nothing here runs when the module is
imported.

``expert_matmul_cuda`` takes CUDA tensors only: it checks them, picks the
kernel's design with ``expert_matmul_design``, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and counts the launch in
``LAUNCH_COUNTS["expert_matmul"]`` and its design in
``DESIGN_COUNTS[("expert_matmul", design)]``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import (ARCH_FLAGS, SHARED_FLAGS, CudaLibrary, check_launch,
                      check_tensor, stream_of)

NVCC_FLAGS = (*ARCH_FLAGS, *SHARED_FLAGS)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = {"fma": 0, "tc": 1}
MAX_GRID = 65535            # C / 16 row tiles and E experts on grid y, z
LIBRARY = CudaLibrary("expert_matmul", NVCC_FLAGS, "expert_matmul_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])


def expert_matmul_design(dtype: torch.dtype, D: int, F: int,
                         aligned: bool = True) -> str:
    """The design a launch takes: "tc" (tensor cores, cp.async ring) for
    bfloat16 whose rows start on 16-byte boundaries (D and F multiples of
    8, ``aligned`` pointers); else "fma" (the FMA units), which takes any
    shape, and float32 at full precision."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 and aligned:
        return "tc"
    return "fma"


def expert_matmul_cuda(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D), w: (E, D, F), contiguous CUDA tensors of one dtype
    (float32 or bfloat16).  Returns (E, C, F) in buf's dtype."""
    if not buf.is_cuda:
        raise ValueError("expert_matmul_cuda takes CUDA tensors; the plain "
                         "version in ref.py serves the CPU")
    if buf.dim() != 3 or w.dim() != 3:
        raise ValueError(f"buf must be (E, C, D) and w (E, D, F); got "
                         f"{tuple(buf.shape)} and {tuple(w.shape)}")
    E, C, D = buf.shape
    F = w.shape[2]
    check_tensor(buf, "buf", (E, C, D), buf.device, tuple(DTYPES))
    check_tensor(w, "w", (E, D, F), buf.device, (buf.dtype,))
    if min(E, C, F) < 1:
        raise ValueError(f"E, C and F must be >= 1; got {E}, {C}, {F}")
    if max(E, -(-C // 16)) > MAX_GRID:
        raise ValueError(f"E and C / 16 must be <= {MAX_GRID}; got E {E}, "
                         f"C {C}")
    if max(D, F) >= 2 ** 31:
        raise ValueError("expert_matmul_cuda takes D and F below 2^31")
    out = torch.empty((E, C, F), dtype=buf.dtype, device=buf.device)
    design = expert_matmul_design(buf.dtype, D, F, all(
        t.data_ptr() % 16 == 0 for t in (buf, w, out)))
    rc = LIBRARY.function()(buf.data_ptr(), w.data_ptr(), out.data_ptr(), E,
                            C, D, F, DTYPES[buf.dtype], DESIGNS[design],
                            buf.device.index or 0, stream_of(buf))
    check_launch("expert_matmul", rc, design)
    return out
