"""AdamW from scratch, the port of ``repro.optim.adamw``: bf16 (or any)
params with float32 moments and float32 master weights.

The state mirrors the param tree leaf for leaf.  The JAX package's
``update`` is pure and builds new ``mu``, ``nu`` and ``master`` trees;
here ``update`` works one leaf at a time and **in place**: it updates
``mu``, ``nu`` and ``master`` and copies the master into the param
tensor.  At recurrentgemma-2b's 3.55e9 parameters the three float32
trees hold 42.6 GB, so a second copy of them would not fit on one 80 GB
card beside the params and gradients.  The state and params passed in
are the ones returned, with the step advanced.

On a mesh (``distributed.sharding.use_mesh``) the params, gradients and
state are this rank's blocks (``mu``, ``nu`` and ``master`` placed as the
params, ``opt_specs``), and ``update`` takes the params' specs: the clip
norm is then the global one (``grad_sumsq``), and the update stays local,
leaf by leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple, Union

import torch


class AdamWState(NamedTuple):
    step: int                  # updates taken
    mu: Any                    # fp32, like params
    nu: Any                    # fp32, like params
    master: Any                # fp32 master weights


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a dict tree, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def grad_sumsq(grads, specs=None) -> torch.Tensor:
    """The float32 sum of squares of every gradient, a sum of per-leaf sums
    (no concatenation).  With ``specs`` (a tree like ``grads`` of the
    leaves' placement specs, on a mesh) each leaf's local sum is
    all-reduced over the axes its spec shards it on, and a replicated
    leaf, the same on every rank, counts once."""
    sums = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if specs is not None:
        from ..distributed import collectives as coll
        from ..distributed.sharding import spec_axes
        groups: dict = {}
        for i, spec in enumerate(tree_leaves(specs)):
            groups.setdefault(spec_axes(spec), []).append(i)
        for axes, idx in groups.items():
            for i, s in zip(idx, coll.all_reduce_many(
                    [sums[i] for i in idx], axes)):
                sums[i] = s
    return sum(sums)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX's weak-typed scalars are."""
    return float(torch.tensor(x, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        def master(p):
            return p.detach().to(torch.float32, copy=True)

        return AdamWState(step=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params),
                          master=tree_map(master, params))

    def _lr(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, specs=None):
        """One step on ``grads`` (a tree like ``params``, any float dtype);
        returns ``(params, state)``, both updated in place.  ``specs``: the
        params' placement on the active mesh, for the global clip norm."""
        step = state.step + 1
        scale = None
        if self.grad_clip:
            gnorm = torch.sqrt(grad_sumsq(grads, specs) + 1e-12)
            scale = torch.clamp(self.grad_clip / gnorm, max=1.0)
        b1, b2 = self.b1, self.b2
        steps = torch.tensor(float(step), dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** steps)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** steps)
        lr = self._lr(step)
        wd = self.weight_decay
        for g, m, v, w, p in zip(*(tree_leaves(t) for t in (
                grads, state.mu, state.nu, state.master, params))):
            g32 = g.float() if scale is None else g.float() * scale
            m.mul_(b1).add_(g32, alpha=_f32(1 - b1))
            v.mul_(b2).addcmul_(g32, g32, value=_f32(1 - b2))
            u = (m / c1).div_((v / c2).sqrt_().add_(self.eps))
            w.sub_(u.add_(w, alpha=wd).mul_(lr))
            p.copy_(w)
        return params, AdamWState(step, state.mu, state.nu, state.master)
