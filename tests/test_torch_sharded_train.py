"""The port's sharded training step against the JAX package's sharded
run, on the CPU.

Seven cases (``torch_train_ranks.CASES``): the JAX package's own
sharded-training tests (phi4-mini smoke on (data 4, model 2) with remat,
h2o-danube smoke on (pod 2, data 2, model 2) with window 8 and no remat),
the first again with two microbatches, qwen3-moe and granite-moe (5
experts: dummy experts, weights gathered over model) smokes on (data 2,
model 2) at capacity factor 1.0 (the all-to-all path, with drops),
qwen3-moe on (data 4, model 1) (the scatter path under FSDP) and
recurrentgemma on (data 4, model 1), all in float32 at 8 x 32 tokens from
seed 0.  The weights are the JAX package's seed-0 init, carried over by
``params_from_jax`` and placed by ``shard_params(..., fsdp=True)``.  The
first three cases run in one 8-rank gloo spawn, the others in one 4-rank
spawn (each with its own hard limit), while one JAX subprocess on 8 forced
host devices jits the reference's ``make_grad_step`` and
``make_train_step`` under ``jax.set_mesh`` with ``param_specs(fsdp=True)``,
``opt_specs`` and ``batch_specs``.  Where pairs drop, the sharded and the
unsharded runs differ, so the MoE cases are held against the reference's
sharded run only.

* before any update: the loss within 1e-5 relative, ``grad_norm`` within
  1e-4 relative, ``moe_aux`` within 1e-6, and each rank's gradient of
  every leaf within a relative RMS of 1e-4 of the reference gradient's
  block at the rank's mesh coordinate; in the MoE cases the routes (each
  pair's expert, and which pairs drop) first equal;
* after two AdamW(lr=1e-3) steps the params within 2e-3 of the
  reference's (its own test's bound), and every leaf that several ranks
  hold is the same bits on each;
* the scale check: with the gradients doubled on the way into AdamW, the
  gradient check fails while the params check still passes, since Adam
  and the clip divide a constant factor out;
* at world size 1 the sharded init and step are the unsharded ones, bit
  for bit.
"""
import json
import select
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model

import torch_train_ranks as ranks

pytestmark = pytest.mark.skipif(
    not hasattr(jax.sharding, "AxisType"),
    reason="requires jax >= 0.6 sharding API (AxisType / set_mesh)")

REPO = Path(__file__).resolve().parents[1]
LIMIT_S = 150
LOSS_RTOL, NORM_RTOL, AUX_ATOL, GRAD_REL_RMS = 1e-5, 1e-4, 1e-6, 1e-4
PARAM_ATOL = 2e-3                 # tests/test_distributed.py's bound
# the cases of each JAX subprocess, balanced by their run times
JAX_LISTS = (ranks.WORLD8 + (ranks.DOUBLED,),
             tuple(c for c in ranks.WORLD4 if c != ranks.DOUBLED))

JAX_RUN = """
import os
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import dataclasses, json, sys
sys.path[:0] = [{src!r}]
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, smoke_config, resolve_for_tp
from repro.distributed import sharding as shd
from repro.models import build_model, moe as moe_mod
from repro.optim import AdamW
from repro.train.loop import make_grad_step, make_train_step

CASES = json.loads({cases!r})
OUT = {out!r}


def key(path):
    return "/".join(str(p.key) for p in path)


def flat(tree, prefix):
    return {{prefix + key(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}


# each MoE layer's routes: the all-to-all path's (flat experts, ranks
# within expert) by (data, model) coordinate, the scatter path's top-k
# experts of every token
seen = []
local_rank = moe_mod._local_rank_in_expert
top_k = jax.lax.top_k


def recorded_rank(flat_e, E):
    r = local_rank(flat_e, E)
    jax.debug.callback(lambda d, m, e, k: seen.append(
        (int(d), int(m), np.asarray(e), np.asarray(k))),
        jax.lax.axis_index("data"), jax.lax.axis_index("model"), flat_e, r)
    return r


def recorded_top_k(x, k):
    v, i = top_k(x, k)
    jax.debug.callback(lambda e: seen.append(np.asarray(e)), i)
    return v, i


def config(arch, extra, tp):
    return resolve_for_tp(dataclasses.replace(
        smoke_config(get_config(arch)), dtype="float32", **extra), tp)


# the seed-0 weights of every case first, for the port's ranks
inits = {{}}
for name, (arch, extra, (pod, dp, tp), remat, accum) in CASES.items():
    inits[name] = build_model(config(arch, extra, tp)).init(
        jax.random.key(0))
    np.savez(f"{{OUT}}/jax-{{name}}-params.npz", **flat(inits[name], "p/"))
print("weights saved", flush=True)

for name, (arch, extra, (pod, dp, tp), remat, accum) in CASES.items():
    cfg = config(arch, extra, tp)
    model = build_model(cfg)
    params = inits[name]
    rng = np.random.default_rng(0)
    batch = {{k: jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 32)))
             for k in ("tokens", "labels")}}
    shape, axes = ((dp, tp), ("data", "model")) if pod == 1 else \\
        ((pod, dp, tp), ("pod", "data", "model"))
    n = pod * dp * tp
    mesh = jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])
    pspecs = shd.param_specs(cfg, jax.eval_shape(lambda: params), tp=tp)
    ospecs = shd.opt_specs(cfg, None, pspecs)
    bspecs = shd.batch_specs(batch, axes[:-1])
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    micro = [{{k: v[j * 8 // accum:(j + 1) * 8 // accum]
              for k, v in batch.items()}} for j in range(accum)]
    out = {{}}
    with jax.set_mesh(mesh):
        grad = jax.jit(make_grad_step(model, remat=remat),
                       in_shardings=(pspecs, bspecs),
                       out_shardings=(None, pspecs))
        if accum == 1:
            loss, grads = grad(params, batch)
        else:
            losses, gs = zip(*(grad(params, m) for m in micro))
            loss = jnp.mean(jnp.stack(losses))
            grads = jax.tree.map(
                lambda *g: sum(x.astype(jnp.float32) / accum for x in g), *gs)
        step = jax.jit(make_train_step(model, opt, mode="scan", remat=remat,
                                       accum=accum),
                       in_shardings=(pspecs, ospecs, bspecs),
                       out_shardings=(pspecs, ospecs, None))
        p, o, m1 = step(params, state, batch)
        p, o, _ = step(p, o, batch)
        if cfg.is_moe:
            seen.clear()
            jax.lax.top_k = recorded_top_k if tp == 1 else top_k
            moe_mod._local_rank_in_expert = recorded_rank
            fwd = jax.jit(lambda q, b: model.loss(q, b)[0],
                          in_shardings=(pspecs, bspecs))
            fwd(params, batch).block_until_ready()
            jax.effects_barrier()
            jax.lax.top_k, moe_mod._local_rank_in_expert = top_k, local_rank
            for j, r in enumerate(seen):
                if isinstance(r, tuple):
                    d, mm, e, k = r
                    out[f"r/{{j}}/coord"] = np.array([d, mm])
                    out[f"r/{{j}}/experts"], out[f"r/{{j}}/ranks"] = e, k
                else:
                    out[f"r/{{j}}/topk"] = r
    out.update(flat(grads, "g/"))
    out.update(flat(p, "p2/"))
    out["loss"] = np.asarray(loss)
    for k, v in m1.items():
        out["m1/" + k] = np.asarray(v)
    np.savez(f"{{OUT}}/jax-{{name}}.npz", **out)
print("ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two JAX subprocesses, each drawing its cases' seed-0 weights and
    then running their sharded references, while the 8-rank spawn and,
    beside it, the 4-rank and the world-size-1 spawns (the port's own
    weights) run on the CPU."""
    out = tmp_path_factory.mktemp("sharded_train")
    one = tmp_path_factory.mktemp("sharded_train_w1")
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_RUN).format(
            src=str(REPO / "src"), out=str(out), cases=json.dumps(
                {c: ranks.CASES[c] for c in cases}))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cases in JAX_LISTS]
    failed = []

    def world(fn, n, args, where):
        try:
            spawn(fn, n, args, timeout_s=LIMIT_S, store_dir=where)
        except Exception as err:            # raised below, in the test
            failed.append(err)

    try:
        for ref in refs:                    # the weights are saved
            ready = select.select([ref.stdout], [], [], LIMIT_S)[0]
            assert ready and ref.stdout.readline().strip() == \
                "weights saved", ref.communicate(timeout=LIMIT_S)[1][-4000:]
        eight = threading.Thread(target=world, args=(
            ranks.train_rank, 8, (str(out), ranks.WORLD8), str(out)))
        eight.start()
        world(ranks.train_rank, 4, (str(out), ranks.WORLD4), str(out))
        world(ranks.world_one_rank, 1, (str(one), ranks.WORLD1), str(one))
        eight.join(LIMIT_S)
        errors = [ref.communicate(timeout=LIMIT_S)[1] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    if failed:
        raise failed[0]
    for ref, stderr in zip(refs, errors):
        assert ref.returncode == 0, stderr[-4000:]
    got = {}
    for case in ranks.CASES:
        world_size = 8 if case in ranks.WORLD8 else 4
        got[case] = [torch.load(out / f"{case}-r{r}.pt", weights_only=False)
                     for r in range(world_size)]
    ref = {case: dict(np.load(out / f"jax-{case}.npz"))
           for case in ranks.CASES}
    w1 = torch.load(one / f"w1-{ranks.WORLD1}.pt", weights_only=False)
    return got, ref, w1


def _specs(case: str) -> dict:
    cfg = ranks.train_config(case)
    tp = ranks.CASES[case][2][2]
    return ranks.flat(shd.param_specs(cfg, build_model(cfg).param_specs(),
                                      tp, fsdp=True))


def _block(arr: np.ndarray, spec, coord: dict, sizes: dict) -> np.ndarray:
    """The block of the whole ``arr`` at mesh coordinate ``coord`` under
    ``spec``."""
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes.get(a, 1), idx * sizes.get(a, 1) \
                + coord.get(a, 0)
        size = arr.shape[d] // n
        arr = arr.take(range(idx * size, (idx + 1) * size), axis=d)
    return arr


def _sizes(case: str) -> dict:
    pod, dp, tp = ranks.CASES[case][2]
    return {"pod": pod, "data": dp, "model": tp}


def _rel_rms(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def grad_problems(case: str, recs: list, ref: dict, key: str = "grads"
                  ) -> list:
    """Leaves whose local gradient on some rank is off the reference
    gradient's block there by more than ``GRAD_REL_RMS``."""
    specs, sizes, out = _specs(case), _sizes(case), []
    for rec in recs:
        grads = rec[key] if key == "grads" else rec[key]["grads"]
        for path, g in grads.items():
            want = _block(ref["g/" + path], specs[path], rec["coord"], sizes)
            if g.shape != want.shape or \
                    not _rel_rms(g.numpy(), want) <= GRAD_REL_RMS:
                out.append((path, rec["coord"],
                            _rel_rms(g.numpy(), want)
                            if g.shape == want.shape else "shape"))
    return out


def param_problems(case: str, recs: list, ref: dict, key: str = "params"
                   ) -> list:
    """Leaves whose local params after two steps are off the reference's
    block by more than ``PARAM_ATOL`` somewhere."""
    specs, sizes, out = _specs(case), _sizes(case), []
    for rec in recs:
        params = rec[key] if key == "params" else rec[key]["params"]
        for path, p in params.items():
            want = _block(ref["p2/" + path], specs[path], rec["coord"], sizes)
            gap = float(np.max(np.abs(p.numpy().astype(np.float64) - want)))
            if not gap <= PARAM_ATOL:
                out.append((path, rec["coord"], gap))
    return out


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_loss_grad_norm_and_aux_match_the_reference(runs, case):
    got, ref, _ = runs
    want = ref[case]
    for rec in got[case]:
        m = rec["metrics"]
        loss = float(want["loss"])
        assert abs(m["loss"] - loss) <= LOSS_RTOL * abs(loss), (m, loss)
        norm = float(want["m1/grad_norm"])
        assert abs(m["grad_norm"] - norm) <= NORM_RTOL * norm, (m, norm)
        aux = float(want["m1/moe_aux"])
        assert abs(m["moe_aux"] - aux) <= AUX_ATOL, (m, aux)
        if "grad_step" in rec:
            assert abs(rec["grad_step"]["loss"] - loss) <= LOSS_RTOL * loss


def _reference_routes(case: str, want: dict, capacity: int) -> list:
    """The reference run's routes as ``(coordinate or None, experts with
    -1 where dropped)`` per layer call."""
    out = []
    j = 0
    while f"r/{j}/coord" in want or f"r/{j}/topk" in want:
        if f"r/{j}/topk" in want:
            e = want[f"r/{j}/topk"].reshape(-1)
            order = np.argsort(e, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(e.size) - np.searchsorted(
                e[order], e[order])
            out.append((None, np.where(rank < capacity, e, -1)))
        else:
            e, r = want[f"r/{j}/experts"], want[f"r/{j}/ranks"]
            out.append((tuple(int(c) for c in want[f"r/{j}/coord"]),
                        np.where(r < capacity, e, -1)))
        j += 1
    return out


@pytest.mark.parametrize("case", [c for c in ranks.CASES if "qwen3" in c
                                  or "granite" in c])
def test_moe_routes_and_dropped_pairs_match_the_reference(runs, case):
    got, ref, _ = runs
    for rec in got[case]:
        calls = rec["routes"]
        assert len(calls) == 2, len(calls)             # the smoke layers
        want = _reference_routes(case, ref[case], calls[0]["capacity"])
        coord = (rec["coord"]["data"], rec["coord"]["model"])
        mine = [e for c, e in want if c in (None, coord)]
        assert len(mine) == len(calls), (coord, len(mine))
        for call in calls:
            e = call["experts"].numpy()
            assert any(np.array_equal(e, w) for w in mine), coord
    dropped = sum(int((~c["keep"]).sum()) for rec in got[case]
                  for c in rec["routes"])
    assert dropped > 0                         # capacity 1.0 drops pairs


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_each_rank_gradient_is_the_reference_block(runs, case):
    got, ref, _ = runs
    assert not grad_problems(case, got[case], ref[case])
    if "grad_step" in got[case][0]:
        for rec in got[case]:                  # make_grad_step: the same
            for path, g in rec["grad_step"]["grads"].items():
                assert torch.equal(g, rec["grads"][path]), path


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_params_after_two_steps_match_the_reference(runs, case):
    got, ref, _ = runs
    assert not param_problems(case, got[case], ref[case])


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_a_leaf_held_by_several_ranks_is_the_same_bits_on_each(runs, case):
    """Ranks whose coordinates agree on every axis a leaf's spec shards
    it over hold the same block: after two steps it must be bitwise
    equal on all of them."""
    got, _, _ = runs
    specs = _specs(case)
    for path, spec in specs.items():
        axes = shd.spec_axes(spec)
        groups: dict = {}
        for rec in got[case]:
            block = tuple(rec["coord"].get(a, 0) for a in axes)
            groups.setdefault(block, []).append(rec["params"][path])
        for block, held in groups.items():
            assert all(torch.equal(held[0], h) for h in held[1:]), \
                (path, block)


def test_doubled_gradients_fail_the_gradient_check_not_the_params_check(
        runs):
    """Adam and the clip divide a constant factor out of the gradient, so
    only the gradient check can see one (a missing 1/dp, a stray tp)."""
    got, ref, _ = runs
    case = ranks.DOUBLED
    assert grad_problems(case, got[case], ref[case], "doubled")
    assert not param_problems(case, got[case], ref[case], "doubled")


def test_world_size_one_is_the_unsharded_step_bitwise(runs):
    _, _, w1 = runs
    mesh, plain = w1["mesh"], w1["plain"]
    assert mesh["metrics"] == plain["metrics"]
    for part in ("grads", "params"):
        assert mesh[part].keys() == plain[part].keys()
        for path in plain[part]:
            assert torch.equal(mesh[part][path], plain[part][path]), path


def test_the_optimizer_state_cut_is_the_local_init(runs):
    """``shard_opt_state`` of the whole state's init is each rank's init
    of its local params (``opt_specs``: the moments and master weights as
    the params)."""
    got, _, _ = runs
    assert all(rec["opt_state_cut"] for rec in got[ranks.GRAD_STEP])
