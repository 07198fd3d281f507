"""What each model kernel op does, counted where it dispatches.

The hand-written kernels are called through ``ctypes``, not through aten
ops, so torch's own counters (``torch.utils.flop_counter``, a dispatch
mode) do not see them.  Each op wrapper (``kernels/{flash_attention,
moe_gmm,linear_scan}/ops.py``) therefore runs its kernel, its plain
version or its ``meta`` branch through ``run``, which tallies the call
in ``OP_TALLY[name]`` on every device, by a closed form of the shapes:

* ``calls``: one a dispatch (on a CUDA tensor, one kernel launch);
* ``flops``: the dot FLOPs the kernel's function needs: attention
  ``2 * B * Hq * pairs * (dq + dv)`` over the unmasked (query, key)
  pairs (causal and window aware), the expert product ``2 * E * C * D *
  F``, the scan none (its multiply-adds are elementwise);
* ``bytes``: each input read once and the output written once.

While the op runs, ``inside()`` is true, so a counter of aten ops
(``launch.op_analysis.StepCounter``) leaves out the plain version's aten
ops on the CPU: a CPU run counts what the card counts.  Each function
of ``HOOKS`` is called with the op's name and output after it returns
(the counter's peak tracker takes the output there).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

OP_TALLY: Dict[str, Dict[str, float]] = {}
HOOKS: List[Callable] = []
_DEPTH = [0]


def reset_tally() -> None:
    OP_TALLY.clear()


def inside() -> bool:
    """True while a kernel op's kernel, plain version or ``meta`` branch
    runs."""
    return _DEPTH[0] > 0


def run(name: str, flops: float, nbytes: int, fn: Callable, *args):
    """Tally one call of the op ``name`` and return ``fn(*args)``."""
    row = OP_TALLY.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0})
    row["calls"] += 1
    row["flops"] += flops
    row["bytes"] += nbytes
    _DEPTH[0] += 1
    try:
        out = fn(*args)
    finally:
        _DEPTH[0] -= 1
    for hook in HOOKS:
        hook(name, out)
    return out


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one sequence and head, queries
    right-aligned (query i at position i + Sk - Sq), as the plain version
    masks them: causal keeps keys at or before the query, a window of w
    the last w of them."""
    q_pos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(q_pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int):
    """(dot FLOPs, bytes) of attention on q (B, Sq, Hq, dq), k (B, Sk,
    Hkv, dq), v (B, Sk, Hkv, dv): q.k and p.v over the unmasked pairs; q,
    k, v read once and the (B, Sq, Hq, dv) output written once."""
    B, Sq, Hq, dq = q.shape
    dv = v.shape[-1]
    pairs = attention_pairs(Sq, k.shape[1], causal, window)
    out_bytes = B * Sq * Hq * dv * q.element_size()
    return 2.0 * B * Hq * pairs * (dq + dv), _nbytes(q, k, v) + out_bytes


def expert_work(buf: torch.Tensor, w: torch.Tensor):
    """(dot FLOPs, bytes) of (E, C, D) x (E, D, F)."""
    E, C, D = buf.shape
    F = w.shape[2]
    return 2.0 * E * C * D * F, _nbytes(buf, w) + E * C * F * \
        buf.element_size()


def scan_work(a: torch.Tensor, b: torch.Tensor):
    """(dot FLOPs, bytes) of the scan over (B, S, D): no dot FLOPs; a and
    b read, h written."""
    return 0.0, 3 * _nbytes(a)
