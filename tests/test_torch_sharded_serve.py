"""The port's sharded serving path against the JAX package's sharded run,
on the CPU.

The smoke qwen3-moe and granite-moe configs in float32 at capacity
factor 1.0, resolved for tp 2, serve 4 prompts of 16 tokens on a (data
2, model 2) mesh of 4 gloo ranks (``repro_torch.launch.mesh.spawn``,
rendezvous through a file store, a 120 s limit on the whole spawn): a
prefill, whose MoE layers take the all-to-all path with the residual
sequence-parallel, and 4 greedy decode steps (the scatter path with the
experts over 'model').  The weights are the JAX package's, carried over
by ``params_from_jax`` and placed by ``shard_params``.  The reference is
the JAX package's prefill and decode, jitted under ``jax.set_mesh`` on a
(2, 2) mesh of forced host devices with ``param_specs(fsdp=False)``,
``cache_specs`` and ``batch_specs``, in one subprocess.  At capacity
factor 1.0 the sharded run drops other pairs than the unsharded one, so
it is held against the sharded reference only.

* each rank's logits (its batch block) within 1e-4 at every step, the
  greedy tokens equal on every rank, and each rank's local cache equal
  (1e-4) to the JAX cache's shard on the device of the same mesh
  coordinate;
* the sharded init keeps exactly this rank's block of the unsharded
  init's weights, and every local weight, wrapped as a DTensor with
  ``placements`` of its spec, gathers back to the whole weight; the
  prefill's collectives are counted (2 all-to-alls a MoE layer);
* with ``SEQ_SHARD_ACTIVATIONS`` off (the residual whole over 'model')
  the prefill gives the same logits (1e-5);
* the same sharded run at world size 1 is the unsharded path bit for
  bit.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

import torch_mesh_ranks as ranks

pytestmark = pytest.mark.skipif(
    not hasattr(jax.sharding, "AxisType"),
    reason="requires jax >= 0.6 sharding API (AxisType / set_mesh)")

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
ARCHS = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m")
LIMIT_S = 120
LOGIT_TOL = 1e-4

JAX_RUN = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, sys
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke_config, resolve_for_tp
from repro.distributed import sharding as shd
from repro.models import build_model
from repro.train.serve import make_decode_step, make_prefill_step
import torch_mesh_ranks as R

def key(path):
    return "/".join(str(p.key) if hasattr(p, "key") else f"[{{p.idx}}]"
                    for p in path)

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
coord = {{d.id: (i, j) for i, row in enumerate(mesh.devices)
         for j, d in enumerate(row)}}
is_p = lambda x: isinstance(x, P)
for arch in {archs!r}:
    pc = R.serve_config(arch, 2)
    cfg = resolve_for_tp(dataclasses.replace(
        smoke_config(get_config(arch)), dtype="float32",
        capacity_factor=1.0), 2)
    assert (cfg.heads, cfg.kv_heads) == (pc.heads, pc.kv_heads)
    model = build_model(cfg)
    with np.load({out!r} + f"/jax-{{arch}}-params.npz") as z:
        flat = dict(z)
    leaves, tree = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: model.init(jax.random.key(0))))
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(flat["p/" + key(k)]) for k, _ in leaves])
    toks = jnp.asarray(R.serve_tokens(pc).numpy(), jnp.int32)
    batch = {{"tokens": toks}}
    cache = model.init_cache(R.SERVE_B, R.S_MAX, stacked=False)
    out = {{}}
    out["unsharded_logits"] = np.asarray(jax.jit(make_prefill_step(model))(
        params, batch, cache)[0])
    pspecs = shd.param_specs(cfg, jax.eval_shape(lambda: params), tp=2,
                             fsdp=False)
    cspecs = shd.cache_specs(cfg, jax.eval_shape(lambda: cache), ("data",),
                             tp=2)
    bspecs = shd.batch_specs(batch, ("data",))
    place = lambda t, s: jax.device_put(t, jax.tree.map(
        lambda sp: NamedSharding(mesh, sp), s, is_leaf=is_p))
    params, cache, batch = (place(params, pspecs), place(cache, cspecs),
                            place(batch, bspecs))
    with jax.set_mesh(mesh):
        prefill = jax.jit(make_prefill_step(model),
                          in_shardings=(pspecs, bspecs, cspecs),
                          out_shardings=(None, cspecs))
        decode = jax.jit(make_decode_step(model),
                         in_shardings=(pspecs, cspecs, P("data", None)),
                         out_shardings=(None, cspecs))
        logits, cache = prefill(params, batch, cache)
        ls, ts = [np.asarray(logits)], []
        for _ in range(R.SERVE_NEW - 1):
            tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(
                jnp.int32)
            ts.append(np.asarray(tok))
            logits, cache = decode(params, cache, tok)
            ls.append(np.asarray(logits))
    ts.append(np.asarray(jnp.argmax(logits[:, -1], -1, keepdims=True)))
    out["logits"] = np.stack(ls)
    out["toks"] = np.concatenate(ts, 1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        if leaf.ndim == 0:
            continue
        for sh in leaf.addressable_shards:
            i, j = coord[sh.device.id]
            out[f"c/{{key(path)}}/{{i}}{{j}}"] = np.asarray(sh.data)
    np.savez({out!r} + f"/jax-{{arch}}.npz", **out)
print("ok")
"""


def _jax_params(arch: str, out: Path) -> None:
    """The JAX package's seed-0 weights of the resolved config, saved
    flat (``p/<path>``) for both sides."""
    from repro.configs import get_config as jget, resolve_for_tp as jres, \
        smoke_config as jsmoke
    from repro.models import build_model as jbuild
    cfg = jres(dataclasses.replace(jsmoke(jget(arch)), dtype="float32",
                                   capacity_factor=1.0), 2)
    params = jbuild(cfg).init(jax.random.key(0))
    flat = {"p/" + "/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(out / f"jax-{arch}-params.npz", **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's weights drawn here; then one JAX subprocess for
    both configs' sharded runs while the world-size-1 spawn (the port's
    own weights) and the 4-rank spawn (the JAX weights) run."""
    out = tmp_path_factory.mktemp("sharded_serve")
    one = tmp_path_factory.mktemp("sharded_serve_w1")
    for arch in ARCHS:
        _jax_params(arch, out)
    script = textwrap.dedent(JAX_RUN).format(
        src=str(REPO / "src"), tests=str(TESTS), archs=ARCHS, out=str(out))
    ref = subprocess.Popen([sys.executable, "-c", script],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        spawn(ranks.serve_rank, 1, (str(one), ARCHS, 1), timeout_s=LIMIT_S,
              store_dir=str(one))
        spawn(ranks.serve_rank, 4, (str(out), ARCHS, 2), timeout_s=LIMIT_S,
              store_dir=str(out))
        _, stderr = ref.communicate(timeout=LIMIT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, stderr[-4000:]
    got = {arch: [torch.load(out / f"{arch}-w4-r{r}.pt", weights_only=False)
                  for r in range(4)] for arch in ARCHS}
    ref = {arch: dict(np.load(out / f"jax-{arch}.npz")) for arch in ARCHS}
    w1 = {arch: torch.load(one / f"{arch}-w1-r0.pt", weights_only=False)
          for arch in ARCHS}
    return got, ref, w1


def _block(arr, d: int):
    """The batch block of data coordinate d (2 blocks)."""
    n = arr.shape[0] // 2
    return arr[d * n:(d + 1) * n]


def _gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_the_reference_sharded_run(runs, arch):
    got, ref, _ = runs
    for rec in got[arch]:
        d = rec["coord"][0]
        gap = _gap(rec["logits"][0].numpy(), _block(ref[arch]["logits"][0], d))
        assert gap <= LOGIT_TOL, (rec["coord"], gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_the_reference_sharded_run(runs, arch):
    got, ref, _ = runs
    for rec in got[arch]:
        d = rec["coord"][0]
        for step in range(1, ranks.SERVE_NEW):
            gap = _gap(rec["logits"][step].numpy(),
                       _block(ref[arch]["logits"][step], d))
            assert gap <= LOGIT_TOL, (rec["coord"], step, gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_on_every_rank(runs, arch):
    got, ref, _ = runs
    want = ref[arch]["toks"]
    for rec in got[arch]:
        assert np.array_equal(rec["toks"].numpy(), want), rec["coord"]
        assert np.array_equal(rec["toks_local"].numpy(),
                              _block(want, rec["coord"][0])[:, :-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_local_cache_is_the_reference_shard(runs, arch):
    got, ref, _ = runs
    for rec in got[arch]:
        d, m = rec["coord"]
        assert rec["cache"]
        for path, leaf in rec["cache"].items():
            want = ref[arch][f"c/{path}/{d}{m}"]
            assert tuple(leaf.shape) == want.shape, (path, rec["coord"])
            assert _gap(leaf.numpy(), want) <= LOGIT_TOL, (path, d, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_one_drops_pairs_so_sharding_changes_the_logits(runs, arch):
    """The comparison is the sharded one because the two runs differ:
    the reference's own sharded and unsharded prefills disagree."""
    _, ref, _ = runs
    assert _gap(ref[arch]["logits"][0], ref[arch]["unsharded_logits"]) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_and_prefill_collectives(runs, arch):
    got, _, _ = runs
    n_moe = 2                                   # the smoke configs' layers
    for rec in got[arch]:
        assert rec["sharded_init_equal"], rec["coord"]
        counts = rec["prefill_counts"]
        assert counts["all_to_all/2"]["calls"] == 2 * n_moe, counts
        assert counts["reduce_scatter/2"]["calls"] >= n_moe, counts


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_without_sequence_parallelism_gives_the_same_logits(runs,
                                                                    arch):
    """With ``SEQ_SHARD_ACTIVATIONS`` off the residual stays whole over
    'model' (partial outputs all-reduced; the MoE cuts its sequence block
    for the all-to-all and gathers it back): another layout of the same
    computation."""
    got, _, _ = runs
    for rec in got[arch]:
        gap = _gap(rec["whole_residual_logits"].numpy(),
                   rec["logits"][0].numpy())
        assert gap <= 1e-5, (rec["coord"], gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_weights_are_the_dtensor_layout_of_their_specs(runs, arch):
    """``shard_params``' blocks, wrapped as DTensors with ``placements``
    of their specs, gather back to the whole weights on every rank."""
    got, _, _ = runs
    assert all(rec["dtensor_equal"] for rec in got[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_world_size_one_is_the_unsharded_path_bitwise(runs, arch):
    _, _, w1 = runs
    rec = w1[arch]
    plain = rec["plain"]
    for a, b in zip(rec["logits"], plain["logits"]):
        assert torch.equal(a, b)
    assert torch.equal(rec["toks"], plain["toks"])
    assert rec["cache"].keys() == plain["cache"].keys()
    for k in plain["cache"]:
        assert torch.equal(rec["cache"][k], plain["cache"][k]), k
    assert rec["sharded_init_equal"]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_batch_the_data_axes_do_not_split_raises(runs, arch):
    """One request on the (data 2, model 2) mesh: ``greedy_generate``
    raises before it runs, naming the batch and the data ranks."""
    got, _, _ = runs
    for rec in got[arch]:
        assert "batch of 1 does not split over 2 data ranks" in \
            rec["one_request_error"], rec["coord"]
