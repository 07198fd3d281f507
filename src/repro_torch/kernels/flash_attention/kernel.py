"""Python binding of the hand-written CUDA ``flash_attention`` kernel.

The source is ``src/repro_torch/csrc/flash_attention.cu`` (the
counterpart of the Pallas ``_flash_fwd_kernel``; its header says what
bounds it and how its design meets that).  It is built and loaded by
``kernels/_build.py`` at first use; nothing here runs when the module is
imported.

``flash_attention_cuda`` takes CUDA tensors only: it checks them, picks
the kernel's design with ``flash_attention_design``, allocates the output
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused (also for too much shared
memory), and counts the launch in ``LAUNCH_COUNTS["flash_attention"]``
and its design in ``DESIGN_COUNTS[("flash_attention", design)]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import (ARCH_FLAGS, SHARED_FLAGS, CudaLibrary, check_launch,
                      check_tensor, stream_of)

NVCC_FLAGS = (*ARCH_FLAGS, *SHARED_FLAGS)
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = {"fma": 0, "tc": 1}
MAX_GRID_Y = 65535          # B * Hq blocks on the grid's second axis
LIBRARY = CudaLibrary(
    "flash_attention", NVCC_FLAGS, "flash_attention_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def flash_attention_design(dtype: torch.dtype, d: int) -> str:
    """The design a launch takes: "tc" (tensor cores, cp.async double
    buffering) for bfloat16 with a head dim of ``HEAD_DIMS`` (all multiples
    of 16); else "fma" (the FMA units), which keeps float32 at full
    precision."""
    if dtype == torch.bfloat16 and d in HEAD_DIMS:
        return "tc"
    return "fma"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d), contiguous CUDA tensors
    of one dtype (float32 or bfloat16; bfloat16 on 16-byte boundaries), d
    in ``HEAD_DIMS``, Hq % Hkv == 0.  Returns (B, Sq, Hq, d) in q's
    dtype."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda takes CUDA tensors; the "
                         "plain version in ref.py serves the CPU")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, S, H, d); got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dtypes = tuple(DTYPES)
    check_tensor(q, "q", (B, Sq, Hq, d), q.device, dtypes)
    check_tensor(k, "k", (B, Sk, Hkv, d), q.device, (q.dtype,))
    check_tensor(v, "v", (B, Sk, Hkv, d), q.device, (q.dtype,))
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}; got {d}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq ({Hq}) must be a multiple of Hkv ({Hkv})")
    if B * Hq > MAX_GRID_Y:
        raise ValueError(f"B * Hq must be <= {MAX_GRID_Y}; got {B * Hq}")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash_attention_cuda indexes rows with int32")
    design = flash_attention_design(q.dtype, d)
    if design == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bfloat16 q, k and v must start on 16-byte "
                         "boundaries: the tensor-core design copies rows "
                         "in 16-byte pieces")
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty_like(q)
    rc = LIBRARY.function()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
        Hq, Hkv, d, scale, int(bool(causal)), int(window), DTYPES[q.dtype],
        DESIGNS[design], q.device.index or 0, stream_of(q))
    check_launch("flash_attention", rc, design)
    return o
