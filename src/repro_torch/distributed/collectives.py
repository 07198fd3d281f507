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
the mesh) is no collective at all.

``COUNTS`` tallies each call by ``(op, group size)``: calls, payload
bytes (the input's) and wire bytes a rank under ring algorithms, the
factors ``repro.launch.hlo_analysis._wire_bytes`` gives XLA's
collectives.  It is the port's collective accounting.
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


def _tally(op: str, n: int, nbytes: int, out_bytes: int) -> None:
    row = COUNTS.setdefault((op, n), {"calls": 0, "bytes": 0,
                                      "wire_bytes": 0.0})
    row["calls"] += 1
    row["bytes"] += nbytes
    row["wire_bytes"] += _wire_bytes(op, nbytes, out_bytes, n)


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
    _tally("all_to_all", n, _nbytes(x), _nbytes(out))
    return out


def all_reduce(x: torch.Tensor, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    if op not in ("sum", "avg"):
        raise ValueError(f"op must be 'sum' or 'avg'; got {op!r}")
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.AVG
    for n, group in _groups(axes):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=red, group=group)
        _tally("all_reduce", n, _nbytes(x), _nbytes(x))
    return x


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
    dim = dim % x.dim()
    for n, group in _groups(axes):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        _tally("all_gather", n, _nbytes(src), _nbytes(out))
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
        _tally("reduce_scatter", n, _nbytes(src), _nbytes(out))
        x = out.movedim(0, dim)
    return x.contiguous()
