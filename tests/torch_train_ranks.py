"""Rank bodies of the port's sharded-training CPU tests, run in fresh
processes by ``repro_torch.launch.mesh.spawn`` (gloo).  This module
imports torch, numpy and the port only: the ranks never import JAX or
``repro``.

The cases are the JAX package's own sharded-training tests
(``tests/test_distributed.py``: phi4-mini on (data 4, model 2), remat on;
h2o-danube on (pod 2, data 2, model 2), window 8, remat off), the first
again with two microbatches, and four more: qwen3-moe and granite-moe
(5 experts, which do not split over model 2) on (data 2, model 2) at
capacity factor 1.0 (the all-to-all path, with drops), qwen3-moe on
(data 4, model 1) (the scatter path under FSDP) and recurrentgemma on
(data 4, model 1) (a family without tensor parallelism).  Every case
takes the reference test's 8 x 32 tokens from seed 0 and the JAX
package's seed-0 weights (``<out>/jax-<case>-params.npz``).

Each rank writes ``<out>/<case>-r<rank>.pt``: its mesh coordinate, the
gradients and metrics of the first ``make_train_step`` step (before its
update), the params after two steps, and, for the MoE cases, each
layer's routes.  The tests hold them against the JAX package's sharded
run, which a subprocess saves beside them.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, resolve_for_tp, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.train.loop import make_grad_step, make_train_step

BATCH, SEQ, LR, STEPS = 8, 32, 1e-3, 2

# name: (arch, extra config fields, (pod, data, model), remat, accum)
CASES = {
    "phi4-d4m2": ("phi4-mini-3.8b", {}, (1, 4, 2), True, 1),
    "danube-p2d2m2": ("h2o-danube-3-4b", {"window": 8}, (2, 2, 2), False, 1),
    "phi4-d4m2-accum2": ("phi4-mini-3.8b", {}, (1, 4, 2), True, 2),
    "qwen3-d2m2-cf1": ("qwen3-moe-30b-a3b", {"capacity_factor": 1.0},
                       (1, 2, 2), True, 1),
    "granite-e5-d2m2-cf1": ("granite-moe-3b-a800m",
                            {"capacity_factor": 1.0, "n_experts": 5},
                            (1, 2, 2), False, 1),
    "qwen3-d4m1-cf1": ("qwen3-moe-30b-a3b", {"capacity_factor": 1.0},
                       (1, 4, 1), False, 1),
    "rgemma-d4m1": ("recurrentgemma-2b", {}, (1, 4, 1), True, 1),
}
WORLD8 = ("phi4-d4m2", "danube-p2d2m2", "phi4-d4m2-accum2")
WORLD4 = ("qwen3-d2m2-cf1", "granite-e5-d2m2-cf1", "qwen3-d4m1-cf1",
          "rgemma-d4m1")
# the case whose gradients the scale check doubles; the case that also
# runs ``make_grad_step``; the config that the world of one trains with
# the port's own weights
DOUBLED, GRAD_STEP = "qwen3-d2m2-cf1", "phi4-d4m2"
WORLD1 = "qwen3-d4m1-cf1"


def train_config(case: str):
    """The smoke config of ``case`` in float32, resolved for its model
    axis (the reference tests' recipe)."""
    arch, extra, (_, _, tp), _, _ = CASES[case]
    cfg = dataclasses.replace(smoke_config(get_config(arch)), dtype="float32",
                              **extra)
    return resolve_for_tp(cfg, tp)


def train_batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
            "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}


class RecordingAdamW(AdamW):
    """AdamW that keeps the gradients of each update it is given, times
    ``scale`` (the scale check's doubled gradients), as the step hands
    them over."""

    def __init__(self, *args, scale: float = 1.0, **kw):
        super().__init__(*args, **kw)
        object.__setattr__(self, "seen", [])
        object.__setattr__(self, "scale", scale)

    def update(self, grads, state, params, specs=None):
        if self.scale != 1.0:
            grads = _scaled(grads, self.scale)
        self.seen.append(_copy(grads))
        return super().update(grads, state, params, specs)


def _scaled(tree, s):
    if isinstance(tree, dict):
        return {k: _scaled(v, s) for k, v in tree.items()}
    return tree * s


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def flat(tree, prefix: str = "") -> dict:
    out = {}
    shd.tree_map_with_path(
        lambda path, leaf: out.__setitem__(prefix + "/".join(path), leaf),
        tree)
    return out


def unflatten(flat_arrays: dict, prefix: str) -> dict:
    """``{"<prefix><a>/<b>": arr}`` -> ``{"a": {"b": arr}}``."""
    tree: dict = {}
    for key, arr in flat_arrays.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


@dataclasses.dataclass
class RouteLog:
    """Each MoE layer call's routes on this rank: the (token, k) pairs'
    experts and which of them were kept."""
    calls: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        self._route, self._local = moe_mod.route, moe_mod.route_local

        def route(p, cfg, x):
            out = self._route(p, cfg, x)
            slot, keep, C = out[1:4]
            self.calls.append({"experts": torch.where(keep, slot // C, -1),
                               "keep": keep.clone(), "capacity": C})
            return out

        def route_local(p, cfg, x):
            out = self._local(p, cfg, x)
            slot, keep, c_send = out[1:4]
            self.calls.append({"experts": torch.where(keep, slot // c_send,
                                                      -1),
                               "keep": keep.clone(), "capacity": c_send})
            return out

        moe_mod.route, moe_mod.route_local = route, route_local
        return self

    def __exit__(self, *exc):
        moe_mod.route, moe_mod.route_local = self._route, self._local


def whole_params(out: str, case: str, cfg):
    with np.load(os.path.join(out, f"jax-{case}-params.npz")) as z:
        tree = unflatten(dict(z), "p/")
    tree.setdefault("tail", {})             # an empty subtree has no leaf
    return params_from_jax(tree, cfg, "cpu")


def _steps(model, params, cfg, case, scale: float = 1.0):
    """Two ``make_train_step`` steps on the active mesh: (first step's
    gradients, its metrics, the params after both)."""
    _, _, _, remat, accum = CASES[case]
    opt = RecordingAdamW(lr=LR, scale=scale)
    state = opt.init(params)
    step = make_train_step(model, opt, mode="scan", remat=remat, accum=accum)
    batch = train_batch(cfg)
    metrics = None
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        metrics = metrics or {k: float(v) for k, v in m.items()}
    return opt.seen[0], metrics, params


def train_rank(rank: int, out: str, cases) -> None:
    """Each of ``cases`` on its mesh over this world."""
    for case in cases:
        _, _, (pod, _, tp), remat, _ = CASES[case]
        mesh = make_host_mesh(model=tp, pod=pod)
        cfg = train_config(case)
        model = build_model(cfg)
        whole = whole_params(out, case, cfg)
        rec = {"coord": dict(zip(mesh.mesh_dim_names,
                                 mesh.get_coordinate()))}
        with shd.use_mesh(mesh):
            local = shd.shard_params(whole, cfg, mesh, tp, fsdp=True)
            if cfg.is_moe:
                with torch.no_grad(), RouteLog() as log:
                    model.loss(local, shd.shard_batch(
                        {k: torch.as_tensor(v) for k, v in
                         train_batch(cfg).items()}))
                rec["routes"] = log.calls
            if case == GRAD_STEP:
                loss, grads = make_grad_step(model, remat=remat)(
                    local, train_batch(cfg))
                rec["grad_step"] = {"loss": float(loss),
                                    "grads": flat(grads)}
            if case == GRAD_STEP:           # the optimizer state's cut
                whole_state = AdamW().init(whole)
                cut = shd.shard_opt_state(whole_state, cfg, mesh, tp)
                mine = AdamW().init(local)
                rec["opt_state_cut"] = cut.step == mine.step and all(
                    torch.equal(a, b) for part in ("mu", "nu", "master")
                    for a, b in zip(flat(getattr(cut, part)).values(),
                                    flat(getattr(mine, part)).values()))
            grads, metrics, params = _steps(model, local, cfg, case)
            rec.update(grads=flat(grads), metrics=metrics,
                       params=flat(params))
            if case == DOUBLED:
                local = shd.shard_params(whole, cfg, mesh, tp, fsdp=True)
                grads, metrics, params = _steps(model, local, cfg, case, 2.0)
                rec["doubled"] = {"grads": flat(grads), "metrics": metrics,
                                  "params": flat(params)}
        torch.save(rec, os.path.join(out, f"{case}-r{rank}.pt"))


def world_one_rank(rank: int, out: str, case: str) -> None:
    """``case``'s config with the port's own seed-0 weights, two steps on
    a mesh of one rank (its sharded init and step) and two without a mesh
    (the unsharded init and step): both records saved."""
    cfg = train_config(case)
    model = build_model(cfg)
    mesh = make_host_mesh()
    rec = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        with shd.use_mesh(m):
            params = model.init(0, "cpu", fsdp=m is not None)
            grads, metrics, params = _steps(model, params, cfg, case)
        rec[label] = {"grads": flat(grads), "metrics": metrics,
                      "params": flat(params)}
    torch.save(rec, os.path.join(out, f"w1-{case}.pt"))


def isolated_train_rank(rank: int, out: str) -> None:
    """A 2-rank (data 1, model 2) sharded train step of the qwen3-moe
    smoke config with the sharded init; fails if JAX or ``repro`` was
    imported on the way."""
    case = "qwen3-d2m2-cf1"
    cfg = train_config(case)
    model = build_model(cfg)
    mesh = make_host_mesh(model=2)
    with shd.use_mesh(mesh):
        params = model.init(0, "cpu", fsdp=True)
        _, metrics, _ = _steps(model, params, cfg, case)
    bad = [m for m, v in sys.modules.items() if v is not None and (
        m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")]
    assert not bad, bad
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    torch.save({"ok": True, "metrics": metrics},
               os.path.join(out, f"isolated-train-r{rank}.pt"))


def _whole(seed: int, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)


def _grads(loss, *xs):
    return [g.detach() for g in torch.autograd.grad(loss, xs)]


def collectives_grad_rank(rank: int, out: str) -> None:
    """Each differentiable collective of ``distributed.collectives`` on a
    (data 2, model 2) mesh in float64, at the place of the model path
    that it serves: this rank's gradients of its local inputs, and the
    same gradients of the computation done whole (on this rank, from the
    same seeds), cut to this rank's blocks.  The objective is
    ``train.loop``'s: each data coordinate's loss once."""
    from repro_torch.distributed import collectives as coll
    mesh = make_host_mesh(model=2)
    d, m = mesh.get_coordinate()
    rec = {"coord": (d, m)}
    with shd.use_mesh(mesh):
        # a weight's FSDP gather over 'data' (reduce-scatter backward)
        W, X, c = _whole(1, 4, 3), _whole(2, 2, 5, 4), _whole(3, 2, 5, 3)
        w = W[2 * d:2 * d + 2].clone().requires_grad_()
        coll.reset_counts()
        got = _grads(torch.sum(c[d] * (X[d] @ coll.gather(w, "data"))), w)
        counts = coll.counts()
        Wr = W.clone().requires_grad_()
        want = _grads(sum(torch.sum(c[j] * (X[j] @ Wr)) for j in range(2)),
                      Wr)
        rec["fsdp_gather"] = (got, [want[0][2 * d:2 * d + 2]], counts)

        # the sequence-parallel gather before column-parallel work, and
        # the vocab gather before a loss every model rank computes alike
        x, W, c = _whole(4, 4, 3), _whole(5, 3, 6), _whole(6, 4, 6)
        xm = x[2 * m:2 * m + 2].clone().requires_grad_()
        wm = W[:, 3 * m:3 * m + 3].clone().requires_grad_()
        y = coll.gather_replicated(coll.gather(xm, "model") @ wm, "model", -1)
        got = _grads(torch.sum(c * torch.tanh(y)), xm, wm)
        xr, Wr = x.clone().requires_grad_(), W.clone().requires_grad_()
        gx, gw = _grads(torch.sum(c * torch.tanh(xr @ Wr)), xr, Wr)
        rec["sp_gather"] = (got, [gx[2 * m:2 * m + 2],
                                  gw[:, 3 * m:3 * m + 3]], None)

        # a row-parallel partial output: reduce-scattered along the
        # sequence (all-gather backward), or all-reduced (identity)
        h, W, c = _whole(7, 4, 6), _whole(8, 6, 3), _whole(9, 4, 3)
        hm = h[:, 3 * m:3 * m + 3].clone().requires_grad_()
        wm = W[3 * m:3 * m + 3].clone().requires_grad_()
        hr, Wr = h.clone().requires_grad_(), W.clone().requires_grad_()
        gh, gw = _grads(torch.sum(c * (hr @ Wr) ** 2), hr, Wr)
        want = [gh[:, 3 * m:3 * m + 3], gw[3 * m:3 * m + 3]]
        y = coll.gather_replicated(coll.scatter(hm @ wm, "model"), "model")
        rec["sp_scatter"] = (_grads(torch.sum(c * y ** 2), hm, wm), want,
                             None)
        y = coll.reduce_partial(hm @ wm, "model")
        rec["reduce_partial"] = (_grads(torch.sum(c * y ** 2), hm, wm), want,
                                 None)

        # a replicated activation entering per-rank work
        h, W, c = _whole(10, 4, 3), _whole(11, 3, 6), _whole(12, 4, 6)
        hh = h.clone().requires_grad_()
        wm = W[:, 3 * m:3 * m + 3].clone().requires_grad_()
        y = coll.gather_replicated(coll.enter(hh, "model") @ wm, "model", -1)
        got = _grads(torch.sum(c * torch.tanh(y)), hh, wm)
        hr, Wr = h.clone().requires_grad_(), W.clone().requires_grad_()
        gh, gw = _grads(torch.sum(c * torch.tanh(hr @ Wr)), hr, Wr)
        rec["enter"] = (got, [gh, gw[:, 3 * m:3 * m + 3]], None)

        # the all-to-all, each rank's loss part summed over 'model'
        X, c = _whole(13, 2, 2, 3, 2), _whole(14, 2, 2, 3, 2)
        xm = X[m].clone().requires_grad_()
        part = torch.sum(c[m] * coll.exchange(xm, "model") ** 2)
        got = _grads(coll.reduce_partial(part, "model"), xm)
        Xr = X.clone().requires_grad_()
        want = _grads(sum(torch.sum(c[r] * torch.stack(
            [Xr[j][r] for j in range(2)]) ** 2) for r in range(2)), Xr)
        rec["exchange"] = (got, [want[0][m]], None)

        # the MoE aux term's mean over every rank of per-rank vectors
        V, c = _whole(15, 2, 2, 5), _whole(16, 5)
        v = V[d, m].clone().requires_grad_()
        got = _grads(torch.sum(c * coll.mean_over_all(
            v, ("data", "model")) ** 2), v)
        Vr = V.clone().requires_grad_()
        want = _grads(2 * torch.sum(c * Vr.mean((0, 1)) ** 2), Vr)
        rec["mean_over_all"] = (got, [want[0][d, m]], None)

        # the scatter path at model > 1 serves only: a backward through
        # it raises instead of losing the gradients of its collectives
        cfg = train_config(DOUBLED)
        p = moe_mod.moe_init(torch.Generator().manual_seed(19), cfg,
                             torch.float32, torch.device("cpu"))
        p = {k: v.requires_grad_() for k, v in p.items()}
        try:
            moe_mod.moe_apply_scatter(p, cfg, _whole(20, 2, 1, cfg.d_model)
                                      .float())
        except NotImplementedError as err:
            rec["scatter_refused"] = str(err)

        # the logits gather's backward is this rank's slice of the
        # cotangent, which every model rank holds alike
        y = _whole(17, 3, 4)[:, 2 * m:2 * m + 2].clone().requires_grad_()
        cot = _whole(18, 3, 4)
        coll.gather_replicated(y, "model", -1).backward(cot)
        rec["vocab_slice"] = (y.grad, cot[:, 2 * m:2 * m + 2])
    torch.save(rec, os.path.join(out, f"collectives-r{rank}.pt"))
