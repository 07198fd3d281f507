"""Checkpointing: save and restore of params, optimizer state and
scheduler state; the port of ``repro.checkpoint.ckpt``, in its format.

Work exchange handles a worker lost within a step; checkpoint and
restart handle a restart of the whole job.  A checkpoint is a directory
``step_<8 digits>`` holding

* ``arrays.npz``: the tree's leaves as ``a0 .. a<N-1>``, in the order
  ``jax.tree.flatten`` gives them: dict keys sorted, tuple, list and
  NamedTuple fields in order, ``None`` no leaf.  A leaf is a tensor, a
  numpy array or a Python scalar (the port's ``AdamWState.step`` is an
  ``int``).
* ``manifest.json``: ``step``, ``n_leaves``, ``extra`` (what the caller
  passed) and ``treedef``.  The JAX package writes JAX's treedef string
  there and reads it back nowhere; the port writes its own description of
  the tree (``describe``) and, like the reference, reads only
  ``n_leaves`` and ``extra``.

So a float32 checkpoint written by either package restores into the
other, leaf for leaf.  numpy has no bfloat16: a bfloat16 leaf is stored as
its raw 16 bits in numpy's two-byte void dtype (``|V2``), the bytes numpy
also writes for the JAX package's bfloat16 arrays, and a ``|V2`` leaf is
read back as bfloat16 bit for bit.

Writes are atomic (a ``.tmp_`` directory, then a rename) and the last
``keep`` checkpoints are kept.  ``reshard_rates`` adapts saved
work-exchange rate estimates to a cluster of another size.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

BF16_RAW = np.dtype("V2")


def _children(tree) -> Optional[List[Any]]:
    """A node's children in ``jax.tree.flatten``'s order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in flatten(kid)]


def _unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves taken from the iterator
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def describe(tree) -> str:
    """The tree's structure, ``*`` for a leaf (the manifest's
    ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={describe(x)}" for f, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(describe(x) for x in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16_RAW)
        return x.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like, i: int):
    shape = tuple(getattr(like, "shape", ()))
    if tuple(arr.shape) != shape:
        raise ValueError(f"leaf {i}: shape {arr.shape} != {shape}")
    if isinstance(like, torch.Tensor):
        # ``np.load`` hands each leaf over as a fresh writable array: the
        # tensor shares its memory, no copy
        if arr.dtype == BF16_RAW:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return np.asarray(arr, dtype=like.dtype)
    return type(like)(arr.item())


def save_checkpoint(directory, step: int, tree: Any,
                    extra: Optional[Dict] = None, keep: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_"))
    arrays = {f"a{i}": _to_numpy(x) for i, x in enumerate(flatten(tree))}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "treedef": describe(tree),
                "n_leaves": len(arrays), "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep)
    return final


def _checkpoints(directory: Path) -> List[Path]:
    return sorted(d for d in directory.iterdir()
                  if d.is_dir() and d.name.startswith("step_"))


def _retain(directory: Path, keep: int) -> None:
    for old in _checkpoints(directory)[:-keep]:
        shutil.rmtree(old)


def latest_checkpoint(directory) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = _checkpoints(directory)
    return ckpts[-1] if ckpts else None


def restore_checkpoint(path, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like``: each leaf takes the type,
    dtype and device of ``like``'s (its shape is checked).  Returns
    ``(tree, extra)``."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves_like = flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"expected {len(leaves_like)} -- structure changed?")
    with np.load(path / "arrays.npz") as data:
        leaves = [_from_numpy(data[f"a{i}"], ref, i)
                  for i, ref in enumerate(leaves_like)]
    return _unflatten(like, iter(leaves)), manifest["extra"]


# ---------------------------------------------------------------------------
# elastic scheduler-state restore
# ---------------------------------------------------------------------------

def reshard_rates(rates: np.ndarray, new_k: int,
                  prior_rate: float = 1.0) -> np.ndarray:
    """Adapt saved per-worker rate estimates to a different cluster size.

    Shrink: keep the first new_k (the surviving workers, by convention).
    Grow: new workers start from the mean of known rates (better prior
    than 1.0 -- they are drawn from the same fleet).
    """
    rates = np.asarray(rates, dtype=np.float64)
    if new_k <= rates.size:
        return rates[:new_k].copy()
    prior = float(rates.mean()) if rates.size else prior_rate
    return np.concatenate([rates, np.full(new_k - rates.size, prior)])
