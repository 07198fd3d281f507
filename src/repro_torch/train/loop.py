"""Training step factory and host loop: the port of ``repro.train.loop``.

PyTorch runs eagerly, so the step is a plain function (the JAX package
jits it).  Gradients come from ``torch.autograd.grad`` over the param
tree's leaves, so they form a tree like the params, as ``jax.grad``'s do.
The step runs on the params' device; a batch of numpy arrays or tensors
is moved there.  ``AdamW.update`` updates in place, so a step returns the
same param and state tensors it was given, advanced: unlike the JAX
package, the params passed to ``fit`` or to a step are trained in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from ..optim.adamw import AdamW, tree_leaves, tree_map


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


def make_train_step(model, opt: AdamW, mode: str = "scan",
                    remat: bool = True, accum: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    accum > 1: gradient accumulation over microbatches.  The batch is
    split on its leading axis; activations live for one microbatch at a
    time, and the gradients are averaged in float32 (as the JAX package's
    ``lax.scan`` accumulates them)."""
    def train_step(params, opt_state, batch):
        batch = _on_device(batch, _device_of(params))
        if accum == 1:
            loss, metrics, grads = _grad_of(model, params, batch, mode,
                                            remat)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, per_micro = [], []
            for j in range(accum):
                micro = {k: v.reshape(accum, v.shape[0] // accum,
                                      *v.shape[1:])[j]
                         for k, v in batch.items()}
                loss_j, metrics_j, g = _grad_of(model, params, micro, mode,
                                                remat)
                for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gg.float() / accum)
                losses.append(loss_j)
                per_micro.append(metrics_j)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}
        params, opt_state = opt.update(grads, opt_state, params)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        out = dict(metrics)
        out.update(loss=loss, grad_norm=gnorm)
        return params, opt_state, out

    return train_step


def make_grad_step(model, mode: str = "scan", remat: bool = False
                   ) -> Callable:
    """``grad_step(params, batch) -> (loss, grads)``: one microbatch's
    gradient, no update (the work-exchange unit op)."""
    def grad_step(params, batch):
        loss, _, grads = _grad_of(model, params,
                                  _on_device(batch, _device_of(params)),
                                  mode, remat)
        return loss, grads
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
