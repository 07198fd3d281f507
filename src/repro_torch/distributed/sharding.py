"""Per-architecture placement rules (params, optimizer state, caches,
batches) and the active mesh: the port of ``repro.distributed.sharding``.

The rules are the JAX package's rule for rule.  A spec is a tuple with
one entry a tensor dim: ``None`` (replicated), a mesh axis name, or a
tuple of axis names (the first major), so ``tuple(P(...))`` of the JAX
package's ``PartitionSpec`` equals the port's spec.  Paths are tuples of
strings, a list index as ``"[j]"`` (what ``str`` of a JAX
``SequenceKey`` gives), so the path rules read the same.

Conventions (the JAX package's):
  * 'model' = tensor parallel (+ expert parallel when E % tp == 0)
  * 'data'  = batch + FSDP: every weight's non-TP matrix dim is sharded
              over 'data' in train mode; serve mode replicates over 'data'
  * 'pod'   = pure DP (gradient reduction only) and the work-exchange domain

The port runs its sharded path eagerly, each rank on its own local
tensors, with the collectives of ``distributed.collectives``.
``use_mesh(mesh)`` installs a ``DeviceMesh`` (``launch.mesh``) for the
model code, as ``jax.set_mesh`` does, and ``active_mesh()`` reads it, as
``jax.sharding.get_abstract_mesh`` does.  ``local_block`` cuts this
rank's block of a whole tensor under a spec; ``placements`` gives the
same layout as DTensor placements; ``shard_params`` turns a whole
parameter tree into this rank's local tensors (the serving layout, or
with ``fsdp`` the training layout) and ``shard_opt_state`` a whole
``AdamWState`` (``opt_specs``); ``fsdp_gather`` all-gathers one local
training-layout leaf over 'data' before use, its gradient
reduce-scattered back (``collectives.gather``).  ``maybe_shard`` resolves
a spec against the active mesh as the JAX package's does (absent axes
and axes that do not divide a dim dropped) and returns this rank's block
of ``x``, which it takes to be whole on every rank: the eager
counterpart of a sharding constraint on a replicated value.  Outside a
mesh it returns ``x``, as the JAX package's does.

The Monte-Carlo grid's device axis (the JAX package's ``grid_mesh``) is
``repro_torch.core.samplers.grid_sharding``: a row split over devices
with no collectives, re-exported here, not copied.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.samplers import grid_devices as grid_mesh  # noqa: F401
from ..core.samplers import grid_sharding  # noqa: F401

Spec = Tuple[Any, ...]

# weights whose (in, out) trailing dims shard (FSDP, model)
_IN_OUT = {"wq", "wk", "wv", "wi_gate", "wi_up", "wi", "w_in", "w_gate",
           "w_a", "w_x", "wq_a", "wq_b", "wk_b", "wv_b", "w_up", "w",
           "vis_proj", "lm_head"}
# weights whose trailing dims shard (model, FSDP)
_OUT_IN = {"wo", "w_out", "w_down"}
# weights replicated on the model axis (small / shared outputs)
_FS_ONLY = {"router", "wkv_a", "w_if"}
_NORM_1D = re.compile(r"^(ln\w*|.*_norm|b|bias)$")

BATCH_AXES = ("pod", "data")

# Megatron-style sequence parallelism for layer-boundary activations:
# residuals are sharded over 'model' along the sequence axis; attention
# gathers the sequence first and reduce-scatters after its output
# projection (the port's prefill; ``models.transformer``).
SEQ_SHARD_ACTIVATIONS = True


# ---------------------------------------------------------------------------
# trees and paths
# ---------------------------------------------------------------------------

def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists; a dict key adds
    ``str(key)`` to the path, a list index ``"[j]"``.  A tuple is a leaf
    (a spec is one)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (f"[{j}]",))
                for j, v in enumerate(tree)]
    return fn(path, tree)


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def _leaf_name(path) -> str:
    return path[-1]


def _entry(e):
    """An entry as ``PartitionSpec`` keeps it: a one-axis tuple is the
    axis, an empty one None."""
    if isinstance(e, (tuple, list)):
        return None if not e else (e[0] if len(e) == 1 else tuple(e))
    return e


def _pad(spec: tuple, ndim: int) -> Spec:
    extra = ndim - len(spec)
    assert extra >= 0, f"rank mismatch: spec {spec} for ndim {ndim}"
    return (None,) * extra + tuple(_entry(e) for e in spec)


def _stack_extra(parts, nd, base) -> int:
    return 1 if any(p in ("body", "enc", "dec") for p in parts) else 0


# ---------------------------------------------------------------------------
# parameter, optimizer, cache and batch specs
# ---------------------------------------------------------------------------

def param_spec(path, leaf, cfg, tp: int = 16, fsdp: bool = True) -> Spec:
    """Sharding for one parameter leaf."""
    name = _leaf_name(path)
    parts = list(path)
    nd = _ndim(leaf)
    fs = "data" if fsdp else None
    moe = cfg.is_moe and "mlp" in parts and name in ("wi_gate", "wi_up", "wo")
    if moe:
        ep = cfg.n_experts % tp == 0
        if name in ("wi_gate", "wi_up"):      # (E, D, F)
            spec = ("model", fs, None) if ep else (None, fs, "model")
        else:                                  # wo (E, F, D)
            spec = ("model", None, fs) if ep else (None, "model", fs)
        return _pad(spec, nd)
    if name == "embed":
        return _pad(("model", fs), nd)
    if name == "r":                            # slstm recurrent (H, 4, dh, dh)
        h = leaf.shape[-4]
        return _pad(("model" if h % tp == 0 else None, None, None, None), nd)
    if name == "conv_w":                       # (W, R)
        width = leaf.shape[-1]
        return _pad((None, "model" if width % tp == 0 else None), nd)
    if name in ("lambda", "skip_scale"):
        return _pad(("model" if leaf.shape[-1] % tp == 0 else None,), nd)
    if _NORM_1D.match(name) or nd - _stack_extra(parts, nd, 1) == 1:
        return _pad((None,), nd) if nd <= 1 else (None,) * nd
    if name in _FS_ONLY:
        return _pad((fs, None), nd)
    if name in _IN_OUT:
        out_dim = leaf.shape[-1]
        return _pad((fs, "model" if out_dim % tp == 0 else None), nd)
    if name in _OUT_IN:
        in_dim = leaf.shape[-2]
        return _pad(("model" if in_dim % tp == 0 else None, fs), nd)
    # default: replicate
    return (None,) * nd


def param_specs(cfg, params_shape, tp: int = 16, fsdp: bool = True):
    """Spec tree matching a (``meta``) param tree."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, cfg, tp, fsdp),
        params_shape)


def opt_specs(cfg, opt_state_shape, pspecs):
    """AdamWState(step, mu, nu, master): moments/master mirror params."""
    from ..optim import AdamWState
    return AdamWState(step=(), mu=pspecs, nu=pspecs, master=pspecs)


def cache_spec(path, leaf, cfg, dp, tp: int = 16,
               batch_shardable: bool = True) -> Spec:
    name = _leaf_name(path)
    parts = list(path)
    nd = _ndim(leaf)
    # stacked caches have a leading layer dim under body keys; UNSTACKED
    # (serving-layout) caches interpose a list index ("[j]") and have none
    has_body = any(p.startswith("b") and p[1:].isdigit() for p in parts)
    has_list = any(p.startswith("[") for p in parts)
    extra = 1 if ((has_body and not has_list)
                  or any(p in ("self", "cross") for p in parts)) else 0
    dps = dp if batch_shardable else None
    if name == "pos":
        return ()
    if name in ("k", "v"):                     # (B, S, Hkv, hd)
        hkv = leaf.shape[-2]
        head_ax = "model" if hkv % tp == 0 else None
        seq_ax = "data" if not batch_shardable else None
        return _pad((dps, seq_ax, head_ax, None), nd)
    if name in ("latent", "k_rope"):           # (B, S, r)
        seq_ax = "data" if not batch_shardable else "model"
        return _pad((dps, seq_ax, None), nd)
    if name == "conv":                         # (B, W-1, R)
        r = leaf.shape[-1]
        return _pad((dps, None, "model" if r % tp == 0 else None), nd)
    if name == "C":                            # mlstm (B, H, dh, dh)
        dh = leaf.shape[-1]
        d_ax = "data" if not batch_shardable and dh % tp == 0 else None
        return _pad((dps, "model", d_ax, None), nd)
    if name in ("n", "m", "c", "h"):
        core = nd - extra
        if core == 2:                          # (B, X): rglru h / mlstm m
            x = leaf.shape[-1]
            return _pad((dps, "model" if x % tp == 0 else None), nd)
        return _pad((dps, "model") + (None,) * (core - 2), nd)
    return (None,) * nd


def cache_specs(cfg, cache_shape, dp, tp: int = 16,
                batch_shardable: bool = True):
    return tree_map_with_path(
        lambda path, leaf: cache_spec(path, leaf, cfg, dp, tp,
                                      batch_shardable),
        cache_shape)


def batch_specs(batch_shape, dp, batch_shardable: bool = True):
    dps = _entry(dp) if batch_shardable else None
    return tree_map_with_path(
        lambda path, leaf: (dps,) + (None,) * (_ndim(leaf) - 1),
        batch_shape)


# ---------------------------------------------------------------------------
# the active mesh
# ---------------------------------------------------------------------------

_MESH: List[Any] = [None]


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model code inside on ``mesh`` (a ``DeviceMesh`` with named
    axes; ``None`` runs it on one device)."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = prev


def active_mesh():
    """The mesh installed by ``use_mesh``, or None."""
    return _MESH[0]


def mesh_shape(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(axis: str) -> int:
    """The active mesh's size along ``axis`` (1 outside a mesh or for an
    axis it lacks)."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh_shape(mesh).get(axis, 1)


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 outside a mesh)."""
    mesh = active_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve_spec(shape, spec, mesh=None) -> Spec:
    """``spec`` against ``mesh`` (the active one by default) as the JAX
    ``maybe_shard`` resolves it: axes absent from the mesh dropped, and
    axes that do not divide the dim (with those kept before them)."""
    mesh = active_mesh() if mesh is None else mesh
    sizes = {} if mesh is None else mesh_shape(mesh)
    out = []
    for dim, s in zip(shape, spec):
        keep, prod = [], 1
        for a in _entry_axes(s):
            if a in sizes and dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return tuple(out) + (None,) * (len(shape) - len(out))


def _block(entry, sizes: Dict[str, int], coords: Dict[str, int]):
    """(number of blocks, this rank's block) of a dim under one entry."""
    n, idx = 1, 0
    for a in _entry_axes(entry):
        n, idx = n * sizes.get(a, 1), idx * sizes.get(a, 1) \
            + coords.get(a, 0)
    return n, idx


def local_block(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a
    view).  An axis the mesh lacks counts as size 1; a dim that its axes
    do not divide raises."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None:
        return x
    sizes = mesh_shape(mesh)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for d, entry in enumerate(spec):
        n, idx = _block(entry, sizes, coords)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} blocks over {entry}")
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


def local_shape(shape, spec, mesh=None) -> Tuple[int, ...]:
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None:
        return tuple(shape)
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n, _ = _block(entry, sizes, {})
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {n} blocks over {entry}")
        out[d] //= n
    return tuple(out)


def placements(spec, mesh) -> list:
    """``spec`` as DTensor placements on ``mesh``: ``Shard(d)`` on each
    mesh dim that names tensor dim d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a in mesh.mesh_dim_names:
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def maybe_shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """This rank's block of the whole ``x`` under ``spec`` resolved
    against the active mesh (see the module docstring); ``x`` itself
    outside a mesh or where nothing shards."""
    mesh = active_mesh()
    if mesh is None:
        return x
    resolved = resolve_spec(x.shape, spec, mesh)
    if all(e is None for e in resolved):
        return x
    return local_block(x, resolved, mesh)


def shard_activations(h: torch.Tensor) -> torch.Tensor:
    """This rank's batch block of (B, S, D) activations."""
    return maybe_shard(h, BATCH_AXES, None, None)


def shard_residual(h: torch.Tensor) -> torch.Tensor:
    """This rank's block of a layer-boundary activation: the batch over
    the data axes and, with ``SEQ_SHARD_ACTIVATIONS``, the sequence over
    'model'."""
    if SEQ_SHARD_ACTIVATIONS:
        return maybe_shard(h, BATCH_AXES, "model", None)
    return maybe_shard(h, BATCH_AXES, None, None)


def shard_params(params, cfg, mesh, tp: int, fsdp: bool = False):
    """This rank's local tensors of a whole parameter tree, placed by
    ``param_specs(fsdp=fsdp)`` at ``tp``: the serving layout by default,
    the training layout (every weight's non-TP matrix dim over 'data')
    with ``fsdp``.  Each local tensor is a copy, so the whole tree can be
    freed."""
    specs = param_specs(cfg, params, tp, fsdp=fsdp)

    def one(path, leaf):
        return local_block(leaf, leaf_at(specs, path), mesh).clone(
            memory_format=torch.contiguous_format)

    return tree_map_with_path(one, params)


def shard_opt_state(state, cfg, mesh, tp: int):
    """This rank's blocks of a whole ``AdamWState`` under ``opt_specs``
    (``mu``, ``nu`` and ``master`` as the training layout's params; the
    step replicated)."""
    pspecs = param_specs(cfg, state.master, tp, fsdp=True)
    specs = opt_specs(cfg, state, pspecs)

    def cut(tree, tree_specs):
        return tree_map_with_path(
            lambda path, leaf: local_block(
                leaf, leaf_at(tree_specs, path), mesh).clone(
                    memory_format=torch.contiguous_format), tree)

    return type(state)(step=state.step, mu=cut(state.mu, specs.mu),
                       nu=cut(state.nu, specs.nu),
                       master=cut(state.master, specs.master))


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in dim order."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def fsdp_gather(leaf: torch.Tensor, spec) -> torch.Tensor:
    """The local ``leaf`` all-gathered over 'data' along the dim its
    ``spec`` gives 'data' (``collectives.gather``: the gradient is
    reduce-scattered back, summed over 'data'); ``leaf`` itself where
    'data' is 1 or absent from the spec."""
    from . import collectives as coll
    for d, entry in enumerate(spec):
        if "data" in _entry_axes(entry):
            return coll.gather(leaf, "data", dim=d)
    return leaf


def shard_batch(batch):
    """This rank's block of every leaf of a whole batch, its leading dim
    over the data axes (which must divide it)."""
    return tree_map_with_path(
        lambda path, leaf: local_block(leaf, (BATCH_AXES,)), batch)


def leaf_at(tree, path):
    """The node of ``tree`` at ``path`` (as ``tree_map_with_path`` writes
    it)."""
    for p in path:
        tree = tree[int(p[1:-1])] if p.startswith("[") else tree[p]
    return tree
