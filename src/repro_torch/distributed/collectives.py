"""Every collective of the port's sharded model path, in one place.

The JAX package lets GSPMD insert its collectives, or names them inside a
``shard_map`` (``repro.models.moe.moe_apply_a2a``); the port runs them
eagerly through ``torch.distributed`` (NCCL between cards, gloo between
CPU processes).  Each wrapper here takes the axes of the active mesh
(``distributed.sharding.use_mesh``) it runs over and returns a new
tensor:

* ``all_to_all(x, axis)``: ``x`` (n, ...) split into n equal chunks along
  dim 0, chunk j to peer j; returns the chunks received, peer-ordered.
* ``all_reduce(x, axes, op)``: the sum (or the mean) over the axes.
* ``all_gather(x, axes, dim)``: the peers' blocks concatenated along
  ``dim``, peer-ordered (the first axis of ``axes`` major).
* ``reduce_scatter(x, axes, dim)``: the sum over the axes, split along
  ``dim``; each peer keeps its block.

Several axes run as one collective a axis, innermost first, which keeps
the JAX package's axis-major order.  An axis of size 1 (or absent from
the mesh) is no collective at all.  These four have no backward.

Training differentiates through the collectives, and each place a
collective is used needs its own backward.  The convention is the one
``train.loop`` states: each rank's loss is the mean over its batch
block, the ranks that differ only on ``model`` compute the same loss and
it counts once, and every replicated activation carries its whole
cotangent on every rank of ``model``.  The ``autograd.Function`` classes below
run the same wrappers forward and backward (so both are tallied):

* ``gather(x, axes, dim)``: all-gather; backward a reduce-scatter (sum).
  A weight's FSDP gather over ``data``, the sequence-parallel gather over
  ``model``, a gather of partial per-rank uses.
* ``scatter(x, axes, dim)``: reduce-scatter; backward an all-gather (the
  sequence-parallel reduce-scatter after ``wo`` or the FFN).
* ``reduce_partial(x, axes)``: all-reduce (sum) of a row-parallel partial
  output; backward the identity.
* ``enter(x, axes)``: the identity; backward an all-reduce (sum) of the
  cotangent.  A replicated value entering work that each rank does on its
  own part (its heads, its sequence block), so each rank's cotangent is a
  partial sum.
* ``gather_replicated(x, axes, dim)``: all-gather before work that every
  rank does alike (the logits over the vocab before the loss); backward
  this rank's block of the cotangent, not a reduce-scatter.
* ``exchange(x, axis)``: all-to-all; backward the same all-to-all (with
  equal splits it is its own transpose).
* ``mean_over_all(x, axes)``: the mean over every rank of ``axes`` of a
  value each loss counts (the MoE aux term's per-expert vectors);
  backward the cotangents summed over the batch axes, over the number of
  ranks.

``COUNTS`` tallies each call by ``(op, group size)``: calls, payload
bytes (the input's) and wire bytes a rank under ring algorithms, the
factors ``repro.launch.hlo_analysis._wire_bytes`` gives XLA's
collectives (those of float32 payloads also as ``f32_wire_bytes``).  It
is the port's collective accounting; with remat it counts the
backward's re-gathers, as the JAX package's HLO does.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

COUNTS: Dict[Tuple[str, int], Dict[str, float]] = {}


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, Dict[str, float]]:
    """``COUNTS`` keyed ``"<op>/<group size>"``, for printing."""
    return {f"{op}/{n}": dict(v) for (op, n), v in sorted(COUNTS.items())}


def _wire_bytes(op: str, nbytes: int, out_bytes: int, n: int) -> float:
    f = (n - 1) / n
    if op == "all_gather":
        return out_bytes * f
    if op == "all_reduce":
        return 2.0 * nbytes * f
    return nbytes * f                     # reduce_scatter, all_to_all


def _tally(op: str, n: int, x: torch.Tensor, out: torch.Tensor) -> None:
    row = COUNTS.setdefault((op, n), {"calls": 0, "bytes": 0,
                                      "wire_bytes": 0.0,
                                      "f32_wire_bytes": 0.0})
    nbytes = _nbytes(x)
    wire = _wire_bytes(op, nbytes, _nbytes(out), n)
    row["calls"] += 1
    row["bytes"] += nbytes
    row["wire_bytes"] += wire
    if x.dtype == torch.float32:
        row["f32_wire_bytes"] += wire


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _groups(axes: Axes):
    """(axis size, process group) of each axis of ``axes`` with more than
    one rank, innermost first."""
    from .sharding import active_mesh, mesh_shape
    mesh = active_mesh()
    if mesh is None:
        return []
    sizes = mesh_shape(mesh)
    return [(sizes[a], mesh.get_group(a)) for a in reversed(_axes(axes))
            if sizes.get(a, 1) > 1]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    groups = _groups(axis)
    if not groups:
        return x
    [(n, group)] = groups
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} of size {n} takes a "
                         f"leading dim of {n}; got {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _tally("all_to_all", n, x, out)
    return out


def all_reduce(x: torch.Tensor, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    if op not in ("sum", "avg"):
        raise ValueError(f"op must be 'sum' or 'avg'; got {op!r}")
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.AVG
    for n, group in _groups(axes):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=red, group=group)
        _tally("all_reduce", n, x, x)
    return x


def all_reduce_many(xs: Sequence[torch.Tensor], axes: Axes,
                    op: str = "sum") -> list:
    """``all_reduce`` of each of ``xs``, bucketed: one collective a dtype
    over the tensors flattened end to end (the per-leaf gradient and norm
    reductions of a training step), then split back; ``xs`` as they are
    where no axis has more than one rank."""
    xs = list(xs)
    if not _groups(axes):
        return xs
    by_dtype: Dict[torch.dtype, list] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([xs[i].reshape(-1) for i in idx]), axes,
                          op)
        for i, part in zip(idx, flat.split([xs[i].numel() for i in idx])):
            xs[i] = part.view(xs[i].shape)
    return xs


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
    dim = dim % x.dim()
    for n, group in _groups(axes):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        _tally("all_gather", n, src, out)
        x = out.movedim(0, dim)
    return x.contiguous()


def reduce_scatter(x: torch.Tensor, axes: Axes, dim: int = 0
                   ) -> torch.Tensor:
    dim = dim % x.dim()
    for n, group in reversed(_groups(axes)):
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter over a group of {n} along a "
                             f"dim of {x.shape[dim]}")
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        _tally("reduce_scatter", n, src, out)
        x = out.movedim(0, dim)
    return x.contiguous()


# ---------------------------------------------------------------------------
# differentiable collectives (see the module docstring)
# ---------------------------------------------------------------------------

def _size(axes: Axes) -> int:
    n = 1
    for size, _ in _groups(axes):
        n *= size
    return n


def _index(axes: Axes) -> int:
    """This rank's block index over ``axes`` (the first axis major)."""
    from .sharding import axis_index, axis_size
    idx = 0
    for a in _axes(axes):
        idx = idx * axis_size(a) + axis_index(a)
    return idx


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axes, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axes, ctx.dim), None, None


class _ReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.dim, ctx.n = dim % x.dim(), x.shape[dim]
        ctx.lo = _index(axes) * ctx.n
        return all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.axis), None


class _MeanOverAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.n = axes, _size(axes)
        return all_reduce(x, axes, "avg")

    @staticmethod
    def backward(ctx, g):
        from .sharding import BATCH_AXES
        batch = tuple(a for a in _axes(ctx.axes) if a in BATCH_AXES)
        return all_reduce(g, batch) / ctx.n, None


def _run(fn, x, *args):
    """``fn`` where any axis of the collective has more than one rank, else
    ``x`` itself (so a world of one makes exactly the unsharded graph)."""
    return fn.apply(x, *args) if _groups(args[0]) else x


def gather(x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
    return _run(_Gather, x, axes, dim)


def scatter(x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
    return _run(_Scatter, x, axes, dim)


def reduce_partial(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return _run(_ReducePartial, x, axes)


def enter(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return _run(_Enter, x, axes)


def gather_replicated(x: torch.Tensor, axes: Axes, dim: int = 0
                      ) -> torch.Tensor:
    return _run(_GatherReplicated, x, axes, dim)


def exchange(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _run(_Exchange, x, axis)


def mean_over_all(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return _run(_MeanOverAll, x, axes)
