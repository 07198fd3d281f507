"""Per-device accounting of one step: the port's counterpart of
``repro.launch.hlo_analysis``.

The JAX package compiles a step and parses the optimized HLO text: dot
FLOPs from shapes and contracting dims, HBM bytes at fusion boundaries,
the wire bytes of every collective, each multiplied by the trip count of
the ``while`` loops around it (``hlo_analysis.py:109 _wire_bytes``,
``:130 parse_hlo``, ``:223 aggregate``).  Nothing here parses HLO.  The
port runs eagerly, so a dispatch mode sees every op the step runs, on
every iteration of every Python loop (layers, microbatches, remat's
recompute, the backward): no trip count multiplies anything.

``StepCounter`` is that mode.  It works on any device (``meta``, ``cpu``,
``cuda``); ``result()`` gives the JAX package's ``aggregate`` keys:

* ``dot_flops``: matmul-like FLOPs, torch's own formulas
  (``torch.utils.flop_counter``) for the aten ops plus each kernel op's
  closed form (``kernels.tally``).  Aten counting is suspended inside a
  kernel op, so a CPU run, which executes the plain version, counts what
  the card counts.
* ``mem_bytes``: an op-boundary census, the operand plus result bytes of
  each aten op and each kernel op's tally; views, metadata and
  allocation ops and the ops' Python scalars are left out.  In eager
  mode every op is a kernel boundary, so this is the counterpart of the
  JAX package's fusion-boundary ``mem_bytes``.
* ``collective_bytes``, ``collective_counts``, ``total_collective_bytes``,
  ``f32_collective_bytes``, ``collective_bytes_bf16norm``: from
  ``distributed.collectives.COUNTS`` (its ring factors,
  ``collectives._wire_bytes``, are the JAX package's), under the JAX
  package's kind names.
* ``peak_bytes``: the peak of live tensor bytes on the step's device
  while the step runs, each storage rounded up to 512 bytes as the CUDA
  caching allocator rounds it; the step's inputs count as live from the
  start.  A storage counts from the op that makes it to its release
  (a finalizer on ``untyped_storage()``).  Inside a kernel op nothing is
  tracked but its output, since the CUDA kernels allocate only that.
  Some aten ops' CUDA implementations allocate working memory of their
  own, below the dispatcher, where no mode sees it: ``WORKSPACE`` gives
  those of the model path in closed form, each added to the live bytes
  while its op runs (on every device, so ``meta`` predicts the card).

Besides: ``aten_flops``, ``kernel_ops`` (``OP_TALLY``'s rows of the
step), ``collectives`` (``COUNTS``'s rows of the step, keyed
``"<op>/<group size>"``), ``by_op`` (each aten op's calls, FLOPs and
bytes) and ``input_bytes``.  The counters are read as
differences, so a counted step leaves ``COUNTS`` and ``OP_TALLY`` as
they would be without it.
"""
from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..distributed import collectives as coll
from ..kernels import tally

KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}
BLOCK = 512                 # the CUDA caching allocator's rounding
# aten ops that move no bytes: allocation without a write, metadata,
# views that the schema does not mark as such
NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "_unsafe_view", "detach", "alias",
              "lift_fresh", "_local_scalar_dense", "set_", "resize_",
              "sym_size", "sym_stride", "sym_numel", "is_same_size",
              "record_stream", "_has_compatible_shallow_copy_type"}


def _tensors(tree) -> list:
    """Every tensor in a tree of dicts, lists, tuples (named ones too)
    and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


def _softmax_backward_workspace(args, out) -> int:
    """The CUDA softmax backward forms ``grad * output`` and then a
    contiguous copy of it where that product is not contiguous."""
    tmp = torch.mul(_meta_like(args[0]), _meta_like(args[1]))
    n = _rounded(_nbytes(tmp))
    return n if tmp.is_contiguous() else 2 * n


def _logsumexp_workspace(args, out) -> int:
    """The CUDA logsumexp forms the row maxima and ``self - maxes``."""
    return _rounded(_nbytes(args[0])) + _rounded(_nbytes(out))


# working memory that an aten op's CUDA implementation allocates below
# the dispatcher, as read from the allocator on an H100 (torch 2.11):
# the ops of the model path whose working memory reaches a step's peak
WORKSPACE = {"_softmax_backward_data": _softmax_backward_workspace,
             "logsumexp": _logsumexp_workspace}


def _diff(now: dict, before: dict) -> dict:
    out = {}
    for key, row in now.items():
        old = before.get(key, {})
        d = {f: v - old.get(f, 0) for f, v in row.items()}
        if d.get("calls", 0):
            out[key] = d
    return out


class StepCounter(TorchDispatchMode):
    """Count one step (see the module docstring).  ``inputs``: the trees
    of tensors the step takes (params, optimizer state, batch, cache),
    live from the start; ``device``: where storages are tracked (default:
    the first input's device)."""

    def __init__(self, inputs: Any = (), device=None):
        super().__init__()
        self._inputs = _tensors(inputs)
        if device is None:
            device = self._inputs[0].device if self._inputs else "cpu"
        self.device_type = torch.device(device).type
        self.aten_flops = 0.0
        self.aten_bytes = 0
        self.by_op: Dict[Any, list] = {}
        self.input_bytes = 0
        self._live: Dict[int, int] = {}
        self._finalizers = []
        self.current = 0
        self.peak = 0
        self._counts = self._tally = None
        self._result: Optional[dict] = None

    # -- peak tracking ------------------------------------------------------

    def _free(self, key: int) -> None:
        self.current -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or \
                    t.device.type != self.device_type:
                continue
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._live:
                continue
            size = _rounded(st.nbytes())
            self._live[key] = size
            self._finalizers.append(weakref.finalize(st, self._free, key))
            self.current += size
            self.peak = max(self.peak, self.current)

    def _on_kernel_op(self, name: str, out) -> None:
        self._track(out)

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        self._counts = copy.deepcopy(coll.COUNTS)
        self._tally = copy.deepcopy(tally.OP_TALLY)
        self._track(self._inputs)
        self.input_bytes = self.current
        tally.HOOKS.append(self._on_kernel_op)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        tally.HOOKS.remove(self._on_kernel_op)
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()
        self._live.clear()
        self._inputs = []
        self._result = self._aggregate()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if tally.inside():
            return out
        self._track(out)
        if func.namespace == "aten":
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        """One aten op's FLOPs and bytes, and its CUDA working memory
        (``WORKSPACE``) on top of the live bytes, its output among them."""
        flops, nbytes = 0.0, 0
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
        name = func._schema.name.split("::")[-1]
        if not func.is_view and name not in NO_TRAFFIC:
            nbytes = sum(_nbytes(t) for t in tree_leaves((args, kwargs, out))
                         if isinstance(t, torch.Tensor))
        self.aten_flops += flops
        self.aten_bytes += nbytes
        row = self.by_op.setdefault(func, [0, 0.0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        work = WORKSPACE.get(name)
        if work is not None:
            self.peak = max(self.peak, self.current + work(args, out))

    # -- the result ---------------------------------------------------------

    def _aggregate(self) -> dict:
        rows = _diff(coll.COUNTS, self._counts)
        kernel_ops = _diff(tally.OP_TALLY, self._tally)
        coll_bytes: Dict[str, float] = {}
        coll_counts: Dict[str, int] = {}
        f32 = 0.0
        for (op, _), row in rows.items():
            kind = KINDS[op]
            coll_bytes[kind] = coll_bytes.get(kind, 0.0) + row["wire_bytes"]
            coll_counts[kind] = coll_counts.get(kind, 0) + int(row["calls"])
            f32 += row.get("f32_wire_bytes", 0.0)
        total = float(sum(coll_bytes.values()))
        return {
            "dot_flops": self.aten_flops + sum(r["flops"] for r in
                                               kernel_ops.values()),
            "mem_bytes": self.aten_bytes + sum(r["bytes"] for r in
                                               kernel_ops.values()),
            "collective_bytes": coll_bytes,
            "collective_counts": coll_counts,
            "total_collective_bytes": total,
            "f32_collective_bytes": f32,
            "collective_bytes_bf16norm": total - 0.5 * f32,
            "peak_bytes": self.peak,
            "input_bytes": self.input_bytes,
            "aten_flops": self.aten_flops,
            "kernel_ops": kernel_ops,
            "collectives": {f"{op}/{n}": row for (op, n), row in
                            sorted(rows.items())},
            "by_op": {str(f): {"calls": c, "flops": fl, "bytes": b}
                      for f, (c, fl, b) in self.by_op.items()},
        }

    def result(self) -> dict:
        """The counts of the step run inside (after the block)."""
        if self._result is None:
            raise RuntimeError("StepCounter.result() is read after its "
                               "block has run")
        return self._result
