"""The dry run: the port's counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch granite-moe-3b-a800m --shape train_4k --mesh single

For every (arch x shape x mesh) cell of the JAX package's sweep it runs
one step of rank 0 of the production mesh, (data 16, model 16) = 256
ranks or (pod 2, data 16, model 16) = 512, on a ``fake`` process group
of that many ranks in this one process: every tensor is a ``meta``
tensor (a shape and a dtype, no memory), every collective is
``torch.distributed``'s on the fake group, and the kernel ops take
their ``meta`` branch.  No card is needed.  The step runs
under ``launch.op_analysis.StepCounter``, which reads per device what
the JAX package's ``lower_cell`` reads from the compiled HLO: the peak
of live bytes, dot FLOPs, op-boundary bytes and collective wire bytes.

How it differs from the JAX package's:

* nothing is lowered or compiled, so there is no HLO to parse and no
  trip count (``op_analysis``'s docstring); ``trace_s`` takes the place
  of ``lower_s`` and ``compile_s``;
* ``dot_flops`` counts each kernel op by its closed form
  (``kernels.tally``): attention over its unmasked pairs only;
* ``mem_bytes`` is an op-boundary census of the eager ops, not XLA's
  fusion boundaries;
* there is no donation, and so no ``--no-donate``: the port's steps
  update params, optimizer state and cache in place, which is what
  donation buys the JAX package;
* a train cell runs the port's sharded step, which takes the training
  layout (FSDP over ``data``) only, so there is no ``--no-fsdp``: the
  JSON's ``fsdp`` says the layout the step took (the training layout
  for a train cell, the serving layout for prefill and decode).

Cells the port cannot run yet are written as ``{"not_ported": true,
"item": ..., "reason": ...}`` (ROADMAP Queue 1), never as a pass: item
12c, the families ``models.transformer.check_mesh`` refuses at tp > 1
(MLA, RG-LRU, xLSTM, the encoder-decoder, the vision frontend); item
12d, a batch the data axes do not divide (``long_500k``'s batch of 1).
The JAX package's ``shape_applicable`` skip keeps its ``skipped`` form.
Any other exception is a failure, and ``main`` exits 1.

The same counter runs on the card: ``count_train``, ``count_prefill``
and ``count_decode`` take inputs on any device, and ``chip_smoke.py``
phase 31 holds the card's counts against this dry run's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from ..configs import (SHAPES, get_config, list_configs, resolve_for_tp,
                       shape_applicable)
from ..distributed import sharding as shd
from ..models import build_model
from ..models.transformer import check_mesh
from ..optim import AdamW
from ..train.loop import make_train_step
from .mesh import dp_axes, make_production_mesh
from .op_analysis import StepCounter

TP = 16


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``fake`` process group of ``world_size`` ranks, this process as
    ``rank``, for the block; raises where a group is initialised."""
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_world({world_size}, {rank}): a process group of "
            f"{dist.get_world_size()} ranks is initialised already")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= shd.mesh_shape(mesh)[a]
    return s


# ---------------------------------------------------------------------------
# a step's inputs on `meta`
# ---------------------------------------------------------------------------

def meta_params(model, fsdp: bool):
    """This rank's parameter blocks on ``meta``: the serving layout, or
    with ``fsdp`` the training layout (the whole tree outside a mesh)."""
    whole = model.param_specs()
    mesh = shd.active_mesh()
    if mesh is None:
        return whole
    return shd.shard_params(whole, model.cfg, mesh, shd.axis_size("model"),
                            fsdp=fsdp)


def meta_cache(model, batch: int, s_max: int, pos: int = 0):
    """This rank's serving cache on ``meta`` for ``batch`` requests of up
    to ``s_max`` tokens (``Model.init_cache``'s blocks), at position
    ``pos``."""
    cache = model.local_cache_specs(batch, s_max)
    cache["pos"] = pos
    return cache


def local_batch(batch):
    """This rank's block of a whole batch (the batch over the data axes)
    as tensors of their own."""
    if shd.active_mesh() is None:
        return batch
    return {k: v.clone() for k, v in shd.shard_batch(batch).items()}


# ---------------------------------------------------------------------------
# counted steps, on any device
# ---------------------------------------------------------------------------

def count_train(model, opt, params, state, batch, mode: str = "unroll",
                remat: bool = True, accum: int = 1) -> dict:
    """``make_train_step``'s step on ``params``, ``state`` and the whole
    ``batch``, counted; the params and state are updated in place.  On a
    mesh the step's parameter specs are built first, outside the count."""
    step = make_train_step(model, opt, mode=mode, remat=remat, accum=accum)
    if shd.active_mesh() is not None:
        model.train_specs(shd.axis_size("model"))
    with StepCounter((params, state, batch)) as counter:
        step(params, state, batch)
    return counter.result()


def count_prefill(model, params, batch, cache, mode: str = "unroll"
                  ) -> tuple:
    """``model.prefill`` on this rank's ``batch`` and ``cache``, counted:
    (counts, the new cache)."""
    with StepCounter((params, batch, cache)) as counter:
        _, cache = model.prefill(params, batch, cache, mode=mode)
    return counter.result(), cache


def count_decode(model, params, cache, tokens, mode: str = "unroll"
                 ) -> tuple:
    """``model.decode_step`` on this rank's ``cache`` and ``tokens``,
    counted: (counts, the new cache)."""
    with StepCounter((params, cache, tokens)) as counter:
        _, cache = model.decode_step(params, cache, tokens, mode=mode)
    return counter.result(), cache


def trace_cell(model, shape, mode: str = "unroll", remat: bool = True,
               accum: int = 1) -> dict:
    """One step of ``shape`` (train, prefill or decode) on ``meta`` on
    the active mesh (or none), counted: a train step in the training
    layout, prefill and decode in the serving layout."""
    B, S = shape.global_batch, shape.seq_len
    inputs = model.input_specs(shape)
    if shape.kind == "train":
        params = meta_params(model, fsdp=True)
        opt = AdamW(lr=3e-4)
        return count_train(model, opt, params, opt.init(params), inputs,
                           mode, remat, accum)
    params = meta_params(model, fsdp=False)
    if shape.kind == "prefill":
        return count_prefill(model, params, local_batch(inputs),
                             meta_cache(model, B, S), mode)[0]
    # decode: one token at the last slot of a full cache
    return count_decode(model, params, meta_cache(model, B, S, pos=S - 1),
                        local_batch(inputs)["tokens"], mode)[0]


# ---------------------------------------------------------------------------
# the JAX package's cell
# ---------------------------------------------------------------------------

def _not_ported(arch, shape_name, mesh_name, item, reason) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "not_ported": True, "item": item, "reason": reason}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               mode: str = "unroll", remat: str = "full",
               accum: int = 1) -> dict:
    """Dry-run one (arch x shape x mesh) cell as rank 0; returns the
    result dict (the JAX package's keys where they mean the same)."""
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    cfg = resolve_for_tp(get_config(arch), TP)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "full-attention arch: long_500k inapplicable"}
    world = 512 if multi_pod else 256
    model = build_model(cfg)
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh.mesh.numel()
        with shd.use_mesh(mesh):
            try:
                check_mesh(cfg, train=shape.is_train)
            except NotImplementedError as e:
                return _not_ported(arch, shape_name, mesh_name, "12c",
                                   str(e))
            dp_total = _dp_size(mesh)
            B = shape.global_batch
            shardable = B % dp_total == 0
            if not shardable:
                return _not_ported(
                    arch, shape_name, mesh_name, "12d",
                    f"a batch of {B} does not split over {dp_total} data "
                    f"ranks (kept whole on every data rank in the JAX "
                    f"package)")
            t0 = time.perf_counter()
            counts = trace_cell(model, shape, mode, remat != "none",
                                accum)
            trace_s = time.perf_counter() - t0
    hlo = {k: counts[k] for k in (
        "collective_bytes", "collective_counts", "dot_flops",
        "f32_collective_bytes", "collective_bytes_bf16norm", "mem_bytes",
        "total_collective_bytes", "aten_flops", "kernel_ops",
        "collectives")}
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": n_dev, "mode": mode, "remat": remat,
        "fsdp": shape.is_train, "accum": accum,
        "batch_shardable": shardable,
        "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": counts["input_bytes"],
                   "peak_bytes_est": counts["peak_bytes"]},
        "cost_analysis": {"flops": counts["dot_flops"],
                          "bytes_accessed": float(counts["mem_bytes"])},
        "hlo": hlo,
    }
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
          f"trace {trace_s:.1f}s, "
          f"peak/dev {counts['peak_bytes'] / 2**30:.2f} GiB, "
          f"dot_flops/dev {counts['dot_flops']:.3e}, "
          f"mem/dev {counts['mem_bytes'] / 2**30:.1f} GiB, "
          f"coll/dev {counts['total_collective_bytes'] / 2**20:.1f} MiB")
    return result


def status(res: dict) -> str:
    """"ok", "skipped" or "not_ported" of a cell's result."""
    if res.get("skipped"):
        return "skipped"
    return "not_ported" if res.get("not_ported") else "ok"


def table(outdir, archs, shapes, meshes=("single", "multi")) -> str:
    """A markdown table of the cells' JSON files in ``outdir``: a row an
    (arch, shape), and for each mesh the status or the counts a device
    (peak GiB, dot FLOPs, collective GiB and calls)."""
    head = "| arch | shape | " + " | ".join(
        f"{m}: peak GiB | dot FLOPs | coll GiB | coll ops" for m in meshes
    ) + " |"
    lines = [head, "|" + " --- |" * (2 + 4 * len(meshes))]
    for arch in archs:
        for shape in shapes:
            row = [arch, shape]
            for m in meshes:
                fn = Path(outdir) / f"{m}__{arch}__{shape}.json"
                res = json.loads(fn.read_text()) if fn.exists() else None
                if res is None or status(res) != "ok":
                    got = "missing" if res is None else status(res)
                    row += [got + (f" {res['item']}" if got == "not_ported"
                                   else "")] + [""] * 3
                    continue
                h = res["hlo"]
                row += [f"{res['memory']['peak_bytes_est'] / 2**30:.2f}",
                        f"{h['dot_flops']:.3e}",
                        f"{h['total_collective_bytes'] / 2**30:.2f}",
                        str(sum(h["collective_counts"].values()))]
            lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default="unroll", choices=["unroll", "scan"])
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--table", action="store_true",
                    help="print the requested cells of --out on both "
                         "meshes as a markdown table, and run nothing")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    if args.table:
        print(table(args.out, archs, shapes))
        return
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"__{args.tag}" if args.tag else ""
            fn = outdir / f"{args.mesh}__{arch}__{shape}{tag}.json"
            if fn.exists() and not args.force:
                print(f"[dryrun] skip existing {fn}")
                continue
            try:
                res = lower_cell(arch, shape, args.mesh == "multi",
                                 args.mode, args.remat, accum=args.accum)
                if status(res) != "ok":
                    print(f"[dryrun] {arch} x {shape} x {args.mesh}: "
                          f"{status(res)} {res.get('item', '')} "
                          f"({res['reason'][:120]})")
                fn.write_text(json.dumps(res, indent=1))
            except Exception as e:
                traceback.print_exc()
                failures.append((arch, shape, str(e)[-300:]))
    if failures:
        print(f"[dryrun] FAILURES: {len(failures)}")
        for f in failures:
            print("  ", f[0], f[1], f[2][:160])
        raise SystemExit(1)
    print("[dryrun] all requested cells OK")


if __name__ == "__main__":
    main()
