"""Python binding of the hand-written CUDA ``linear_scan`` kernel.

The source is ``src/repro_torch/csrc/linear_scan.cu`` (the counterpart of
the Pallas ``_scan_kernel``; its header says what bounds it and how its
two designs meet that).  It is built and loaded by ``kernels/_build.py``
at first use; nothing here runs when the module is imported.

``linear_scan_cuda`` takes CUDA tensors only: it checks them, picks the
kernel's design with ``linear_scan_design``, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and counts the launch in
``LAUNCH_COUNTS["linear_scan"]`` and its design in
``DESIGN_COUNTS[("linear_scan", design)]``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import (ARCH_FLAGS, SHARED_FLAGS, CudaLibrary, check_launch,
                      check_tensor, stream_of)

# --fmad=false: a*h + b rounds after the multiply, as the plain version does
NVCC_FLAGS = (*ARCH_FLAGS, "--fmad=false", *SHARED_FLAGS)
ENTRIES = {"ring": "linear_scan_ring_launch", "direct": "linear_scan_launch"}
LIBRARY = CudaLibrary("linear_scan", NVCC_FLAGS, ENTRIES["direct"],
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])


def linear_scan_design(D: int, aligned: bool = True) -> str:
    """The design a launch takes: "ring" (TMA copies through a
    shared-memory ring) where TMA can describe the rows, i.e. D a multiple
    of 4 (rows of 16-byte multiples) and a, b and h on 16-byte boundaries
    (``aligned``); else "direct" (one thread per channel), which takes any
    shape."""
    return "ring" if D % 4 == 0 and aligned else "direct"


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t, h_{-1} = 0, for contiguous float32
    ``(B, S, D)`` CUDA tensors ``a`` and ``b``."""
    if not a.is_cuda:
        raise ValueError("linear_scan_cuda takes CUDA tensors; the plain "
                         "version in ref.py serves the CPU")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, D); got {tuple(a.shape)}")
    B, S, D = a.shape
    check_tensor(a, "a", (B, S, D), a.device)
    check_tensor(b, "b", (B, S, D), a.device)
    if B * S * D >= 2 ** 31:
        raise ValueError(f"linear_scan_cuda indexes with int32; got "
                         f"{B * S * D} elements")
    h = torch.empty_like(a)
    design = linear_scan_design(D, all(t.data_ptr() % 16 == 0
                                       for t in (a, b, h)))
    rc = LIBRARY.function(ENTRIES[design])(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D,
        a.device.index or 0, stream_of(a))
    check_launch("linear_scan", rc, design)
    return h
