"""Python binding of the hand-written CUDA ``linear_scan`` kernel.

The source is ``src/repro_torch/csrc/linear_scan.cu`` (the counterpart of
the Pallas ``_scan_kernel``; its header says what bounds it and how its
one-thread-per-channel design meets that).  It is built and loaded by
``kernels/_build.py`` at first use; nothing here runs when the module is
imported.

``linear_scan_cuda`` takes CUDA tensors only: it checks them, allocates
the output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCH_COUNTS["linear_scan"]``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import (ARCH_FLAGS, SHARED_FLAGS, CudaLibrary, check_launch,
                      check_tensor, stream_of)

# --fmad=false: a*h + b rounds after the multiply, as the plain version does
NVCC_FLAGS = (*ARCH_FLAGS, "--fmad=false", *SHARED_FLAGS)
LIBRARY = CudaLibrary("linear_scan", NVCC_FLAGS, "linear_scan_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])


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
    rc = LIBRARY.function()(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S,
                            D, a.device.index or 0, stream_of(a))
    check_launch("linear_scan", rc)
    return h
