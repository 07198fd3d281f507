"""Rank bodies of the port's CPU mesh tests, run in fresh processes by
``repro_torch.launch.mesh.spawn`` (gloo).  This module imports torch,
numpy and the port only: the ranks never import JAX or ``repro``.

Each body writes what it computed to ``<out>/<tag>-r<rank>.pt``; the
tests read those files and hold them against the JAX package's sharded
run, which a subprocess saves beside them.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, resolve_for_tp, smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, moe as moe_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.train.serve import (greedy_generate, make_decode_step,
                                     make_prefill_step)

SERVE_B, SERVE_S, SERVE_NEW, S_MAX = 4, 16, 5, 24
MOE_X = (4, 16, 32)


def serve_config(arch: str, tp: int):
    """The smoke config of ``arch`` in float32 at capacity factor 1.0
    (pairs drop), resolved for ``tp``."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), dtype="float32",
                              capacity_factor=1.0)
    return resolve_for_tp(cfg, tp)


def serve_tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (SERVE_B, SERVE_S)))


def unflatten(flat: dict, prefix: str) -> dict:
    """``{"<prefix><a>/<b>": arr}`` -> ``{"a": {"b": arr}}``."""
    tree: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def flat_cache(cache) -> dict:
    out = {}

    def put(path, leaf):
        if isinstance(leaf, torch.Tensor):
            out["/".join(path)] = leaf.clone()

    shd.tree_map_with_path(put, cache)
    return out


def _leaves(tree) -> list:
    out = []
    shd.tree_map_with_path(lambda path, leaf: out.append(leaf), tree)
    return out


def _serve(model, params, toks):
    """Prefill and SERVE_NEW - 1 decode steps on this rank's batch block,
    feeding back the argmax: (logits a step, local tokens, cache, the
    prefill's collective counts)."""
    cache = model.init_cache(SERVE_B, S_MAX, "cpu")
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    coll.reset_counts()
    logits, cache = prefill(params, shd.shard_batch({"tokens": toks}), cache)
    prefill_counts = coll.counts()
    out, tok_local = [logits], []
    for _ in range(SERVE_NEW - 1):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        tok_local.append(tok)
        logits, cache = decode(params, cache, tok)
        out.append(logits)
    return out, torch.cat(tok_local, 1), cache, prefill_counts


def serve_rank(rank: int, out: str, archs, model_axis: int) -> None:
    """The sharded serve of each of ``archs`` on a (world / model_axis,
    model_axis) mesh: with the JAX package's weights from
    ``<out>/jax-<arch>-params.npz`` where it exists, else the port's own seed-0
    weights (and then the unsharded path beside it)."""
    mesh = make_host_mesh(model=model_axis)
    for arch in archs:
        cfg = serve_config(arch, model_axis)
        model = build_model(cfg)
        toks = serve_tokens(cfg)
        src = os.path.join(out, f"jax-{arch}-params.npz")
        rec = {"coord": list(mesh.get_coordinate())}
        if os.path.exists(src):
            with np.load(src) as z:
                tree = unflatten(dict(z), "p/")
            tree.setdefault("tail", {})      # an empty subtree has no leaf
            whole = params_from_jax(tree, cfg, "cpu")
        else:
            whole = model.init(0, "cpu")
            logits, _, cache, _ = _serve(model, whole, toks)
            gen, _ = greedy_generate(model, whole, {"tokens": toks},
                                     model.init_cache(SERVE_B, S_MAX, "cpu"),
                                     SERVE_NEW)
            rec["plain"] = {"logits": logits, "toks": gen,
                            "cache": flat_cache(cache)}
        params = shd.shard_params(whole, cfg, mesh, model_axis)
        if model_axis > 1:
            rec["dtensor_equal"] = dtensor_round_trip(whole, params, cfg,
                                                      mesh, model_axis)
        with shd.use_mesh(mesh):
            own = model.init(0, "cpu")
            mine = shd.shard_params(_unsharded_init(model), cfg, mesh,
                                    model_axis)
            rec["sharded_init_equal"] = all(
                torch.equal(a, b) for a, b in zip(_leaves(own),
                                                  _leaves(mine)))
            logits, toks_local, cache, counts = _serve(model, params, toks)
            shd.SEQ_SHARD_ACTIVATIONS = False   # the residual whole
            try:
                rec["whole_residual_logits"] = model.prefill(
                    params, shd.shard_batch({"tokens": toks}),
                    model.init_cache(SERVE_B, S_MAX, "cpu"))[0]
            finally:
                shd.SEQ_SHARD_ACTIVATIONS = True
            gen, _ = greedy_generate(model, params, {"tokens": toks},
                                     model.init_cache(SERVE_B, S_MAX, "cpu"),
                                     SERVE_NEW)
            if shd.axis_size("data") > 1:
                try:
                    greedy_generate(model, params, {"tokens": toks[:1]},
                                    None, 2)
                except ValueError as err:
                    rec["one_request_error"] = str(err)
        rec.update(logits=logits, toks_local=toks_local, toks=gen,
                   cache=flat_cache(cache), prefill_counts=counts)
        world = mesh.mesh.numel()
        torch.save(rec, os.path.join(out, f"{arch}-w{world}-r{rank}.pt"))


def dtensor_round_trip(whole, local, cfg, mesh, tp: int) -> bool:
    """Each local leaf, as a DTensor with ``placements`` of its spec,
    gathers back to the whole leaf."""
    from torch.distributed.tensor import DTensor
    specs = shd.param_specs(cfg, whole, tp, fsdp=False)
    flat_w, flat_l, flat_s = (_leaves(t) for t in (whole, local, specs))
    return all(
        torch.equal(DTensor.from_local(l, mesh, shd.placements(s, mesh),
                                       shape=w.shape, stride=w.stride())
                    .full_tensor(), w)
        for w, l, s in zip(flat_w, flat_l, flat_s))


def _unsharded_init(model):
    with shd.use_mesh(None):
        return model.init(0, "cpu")


def moe_rank(rank: int, out: str) -> None:
    """``moe_apply_a2a`` of every case on the (2, 2) mesh, on this rank's
    token block and serving-layout weights from ``<out>/inputs.npz``."""
    mesh = make_host_mesh(model=2)
    with np.load(os.path.join(out, "inputs.npz")) as z:
        flat = dict(z)
    recs = {}
    for case in MOE_CASES:
        cfg = moe_config(case)
        p = {k: torch.from_numpy(np.array(flat[f"{case}/p/{k}"]))
             for k in ("router", "wi_gate", "wi_up", "wo")}
        x = torch.from_numpy(np.array(flat[f"{case}/x"]))
        specs = shd.param_specs(cfg, {"mlp": p}, 2, fsdp=False)["mlp"]
        local_p = {k: shd.local_block(v, specs[k], mesh).contiguous()
                   for k, v in p.items()}
        x_loc = shd.local_block(x, ("data", "model", None), mesh).contiguous()
        with shd.use_mesh(mesh):
            coll.reset_counts()
            got, aux = moe_mod.moe_apply_a2a(local_p, cfg, x_loc)
            counts = coll.counts()
            keep = moe_mod.route_local(local_p, cfg, x_loc)[2]
            dropped = coll.all_reduce((~keep).sum(), ("data", "model"))
            via_apply = moe_mod.moe_apply(local_p, cfg, x_loc,
                                          seq_sharded=True)[0]
            moe_mod.MOE_IMPL = "scatter"
            try:
                coll.reset_counts()
                pinned = moe_mod.moe_apply(local_p, cfg, x_loc,
                                           seq_sharded=True)[0]
                pinned_counts = coll.counts()
            finally:
                moe_mod.MOE_IMPL = "auto"
        recs[case] = {"out": got, "aux": aux, "dropped": int(dropped),
                      "counts": counts,
                      "apply_equal": bool(torch.equal(via_apply, got)),
                      "pinned": pinned, "pinned_counts": pinned_counts,
                      "scatter": moe_mod.moe_apply_scatter(p, cfg, x)[0]}
    torch.save({"coord": list(mesh.get_coordinate()), "cases": recs},
               os.path.join(out, f"moe-r{rank}.pt"))


MOE_CASES = {
    # qwen3-like: E 8, top-2, at a capacity that drops pairs
    "qwen3-e8-cf1": ("qwen3-moe-30b-a3b", 8, 1.0),
    # granite-like: E 5 does not split over model 2 (dummy experts)
    "granite-e5-cf1": ("granite-moe-3b-a800m", 5, 1.0),
    # drop-free: the reference test's setting
    "qwen3-e8-cf8": ("qwen3-moe-30b-a3b", 8, 8.0),
}


def moe_config(case: str):
    arch, E, cf = MOE_CASES[case]
    return dataclasses.replace(
        smoke_config(get_config(arch)), dtype="float32", d_model=MOE_X[2],
        n_experts=E, experts_per_token=2, d_ff=16, capacity_factor=cf)


def isolated_prefill_rank(rank: int, out: str) -> None:
    """A 2-rank (data 1, model 2) sharded prefill of the qwen3 smoke
    config; fails if JAX or ``repro`` was imported on the way."""
    mesh = make_host_mesh(model=2)
    cfg = serve_config("qwen3-moe-30b-a3b", 2)
    model = build_model(cfg)
    with shd.use_mesh(mesh):
        params = model.init(0, "cpu")
        logits, _ = model.prefill(params, {"tokens": serve_tokens(cfg)},
                                  model.init_cache(SERVE_B, S_MAX, "cpu"))
    bad = [m for m, v in sys.modules.items() if v is not None and (
        m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")]
    assert not bad, bad
    assert logits.shape == (SERVE_B, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all())
    torch.save({"ok": True}, os.path.join(out, f"isolated-r{rank}.pt"))
