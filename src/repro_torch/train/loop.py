"""Training step factory and host loop: the port of ``repro.train.loop``.

PyTorch runs eagerly, so the step is a plain function (the JAX package
jits it).  Gradients come from ``torch.autograd.grad`` over the param
tree's leaves, so they form a tree like the params, as ``jax.grad``'s do.
The step runs on the params' device; a batch of numpy arrays or tensors
is moved there.  ``AdamW.update`` updates in place, so a step returns the
same param and state tensors it was given, advanced: unlike the JAX
package, the params passed to ``fit`` or to a step are trained in place.

On a mesh (``distributed.sharding.use_mesh``) a step takes this rank's
training-layout params and state (``Model.init(..., fsdp=True)``,
``param_specs(fsdp=True)``, ``opt_specs``) and the whole batch, and runs
data parallelism over ``("pod", "data")``, FSDP over ``data`` and tensor
and expert parallelism over ``model``.  One convention fixes every
backward.  The objective is the JAX package's: the mean loss over the
global batch.  Each rank computes the loss of its own batch block (the
global batch over the batch axes); ranks that differ only on ``model``
compute the same loss, and it counts once.  Each collective's backward
(``distributed.collectives``) follows from that, so after the backward a
rank's gradient of a leaf is the gradient of its group's loss; an FSDP
leaf's is already summed over ``data`` by its gather's reduce-scatter.
The step then sums every other leaf over ``data``, divides by the data
ranks once and averages every leaf over ``pod`` (pure data
parallelism): each rank holds its block of the global gradient, and a
leaf it holds alike with other ranks is the same bits on each.  The
reported loss and metrics are the global batch's, the clip norm and
``grad_norm`` global (``optim.adamw.grad_sumsq``).  At world size 1 this
is the unsharded step, bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from ..optim.adamw import AdamW, grad_sumsq, tree_leaves, tree_map


def _device_of(params) -> torch.device:
    return next(tree_leaves(params)).device


def _on_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (integer ones as
    int64, what indexing and ``gather`` take)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.long() if not t.is_floating_point() else t
    return out


def _grad_of(model, params, batch, mode: str, remat: bool):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the grads
    are a tree like ``params`` in its dtypes."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch, mode=mode, remat=remat)
    flat = iter(torch.autograd.grad(loss, list(tree_leaves(leaves))))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(lambda _: next(flat), params)


def _mesh_specs(model):
    """The params' training-layout specs on the active mesh (None outside
    one)."""
    # imported here: ``distributed`` imports ``hetsched``, which imports
    # this module through ``hettrain.engine``
    from ..distributed import sharding as shd
    if shd.active_mesh() is None:
        return None
    return model.train_specs(shd.axis_size("model"))


def _local(batch, specs):
    """This rank's block of the whole batch over the batch axes (on a
    mesh)."""
    from ..distributed import sharding as shd
    return batch if specs is None else shd.shard_batch(batch)


def _reduce_grads(grads, specs):
    """Each rank's gradients of its group's loss (see the module
    docstring) to its blocks of the global batch's mean gradient: the
    leaves not sharded over 'data' summed over it, every leaf divided by
    the data ranks and averaged over 'pod' (each reduction one collective
    a dtype, ``collectives.all_reduce_many``)."""
    from ..distributed import collectives as coll
    from ..distributed import sharding as shd
    flat = list(tree_leaves(grads))
    mine = [i for i, spec in enumerate(tree_leaves(specs))
            if "data" not in shd.spec_axes(spec)]
    for i, g in zip(mine, coll.all_reduce_many([flat[i] for i in mine],
                                               "data")):
        flat[i] = g
    dp = shd.axis_size("data")
    if dp > 1:
        flat = [g / dp for g in flat]
    it = iter(coll.all_reduce_many(flat, "pod", "avg"))
    return tree_map(lambda _: next(it), grads)


def _global_loss(loss: torch.Tensor, specs) -> torch.Tensor:
    from ..distributed import collectives as coll
    from ..distributed.sharding import BATCH_AXES
    return loss if specs is None else coll.all_reduce(loss, BATCH_AXES, "avg")


def make_train_step(model, opt: AdamW, mode: str = "scan",
                    remat: bool = True, accum: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    accum > 1: gradient accumulation over microbatches.  The batch is
    split on its leading axis; activations live for one microbatch at a
    time, and the gradients are averaged in float32 (as the JAX package's
    ``lax.scan`` accumulates them).  On a mesh each microbatch of the
    global batch is split over the batch axes, as the JAX package's are,
    and each rank accumulates its local blocks."""
    def train_step(params, opt_state, batch):
        batch = _on_device(batch, _device_of(params))
        specs = _mesh_specs(model)
        if accum == 1:
            loss, metrics, grads = _grad_of(model, params,
                                            _local(batch, specs), mode, remat)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, per_micro = [], []
            for j in range(accum):
                micro = {k: v.reshape(accum, v.shape[0] // accum,
                                      *v.shape[1:])[j]
                         for k, v in batch.items()}
                loss_j, metrics_j, g = _grad_of(
                    model, params, _local(micro, specs), mode, remat)
                for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gg.float() / accum)
                losses.append(loss_j)
                per_micro.append(metrics_j)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}
        if specs is not None:
            grads = _reduce_grads(grads, specs)
        params, opt_state = (opt.update(grads, opt_state, params)
                             if specs is None else
                             opt.update(grads, opt_state, params, specs))
        out = dict(metrics)
        out.update(loss=_global_loss(loss, specs),
                   grad_norm=torch.sqrt(grad_sumsq(grads, specs)))
        return params, opt_state, out

    return train_step


def make_grad_step(model, mode: str = "scan", remat: bool = False
                   ) -> Callable:
    """``grad_step(params, batch) -> (loss, grads)``: one microbatch's
    gradient, no update (the work-exchange unit op).  On a mesh: the
    global batch's loss and this rank's blocks of its mean gradient."""
    def grad_step(params, batch):
        specs = _mesh_specs(model)
        loss, _, grads = _grad_of(
            model, params, _local(_on_device(batch, _device_of(params)),
                                  specs), mode, remat)
        if specs is not None:
            grads = _reduce_grads(grads, specs)
        return _global_loss(loss, specs), grads
    return grad_step


def fit(model, params, opt: AdamW, batches: Iterable[Dict[str, Any]],
        mode: str = "scan", remat: bool = False, log_every: int = 10,
        callback: Optional[Callable[[int, Dict[str, float]], None]] = None
        ) -> Tuple[Any, Any, list]:
    """Simple synchronous host loop.  Returns (params, opt_state,
    history); ``params`` are the tensors passed in, trained in place."""
    step_fn = make_train_step(model, opt, mode, remat)
    opt_state = opt.init(params)
    history = []
    for i, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or callback:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if callback:
                callback(i, m)
    return params, opt_state, history
