"""The port's placement rules and mesh builders against the JAX
package's, on the CPU (no process is spawned).

* ``resolve_for_tp`` gives the reference's config, field for field, for
  every name in ``list_configs()`` at tp in {1, 2, 4, 8, 16}; at tp 4
  qwen3-moe-30b-a3b keeps its published 32 Q / 4 KV heads.
* ``param_specs`` (FSDP and serving), ``opt_specs``, ``cache_specs``
  (the serving layout, the batch shardable and not) and ``batch_specs``
  give the reference's ``PartitionSpec`` leaf by leaf, over trees whose
  shapes and dtypes equal the reference's: every config's smoke shape at
  tp 2 and its full shape at tp 4 and 16 (the port's on the ``meta``
  device, the reference's under ``jax.eval_shape``).
* ``maybe_shard``, ``shard_activations`` and ``shard_residual`` return
  their input outside a mesh; the production mesh names the world size
  it needs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import resolve_for_tp as jresolve
from repro.configs import smoke_config as jsmoke
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild
from repro_torch.configs import (SHAPES, get_config, list_configs,
                                 resolve_for_tp, smoke_config)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model

NAMES = list_configs()
TPS = (1, 2, 4, 8, 16)
CELLS = [(n, "smoke", 2) for n in NAMES] + [
    (n, "full", tp) for n in NAMES for tp in (4, 16)]
DP = ("data",)


def _cfgs(name: str, size: str, tp: int):
    if size == "smoke":
        return (resolve_for_tp(smoke_config(get_config(name)), tp),
                jresolve(jsmoke(jget_config(name)), tp))
    return (resolve_for_tp(get_config(name), tp),
            jresolve(jget_config(name), tp))


def _jflat(tree) -> dict:
    """``{path: leaf}`` of a JAX tree, a path as the port writes it."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(p.key) if hasattr(p, "key") else f"[{p.idx}]"
                  for p in path): leaf for path, leaf in flat}


def _flat(tree) -> dict:
    out = {}

    def put(path, leaf):
        out[path] = leaf

    shd.tree_map_with_path(put, tree)
    return out


def _same_shapes(port, ref):
    a, b = _flat(port), _jflat(ref)
    assert a.keys() == b.keys()
    for k in a:
        if not isinstance(a[k], torch.Tensor):       # the cache cursor
            continue
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        assert str(a[k].dtype).split(".")[-1] == str(b[k].dtype), k


def _same_specs(port, ref):
    a, b = _flat(port), _jflat(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == tuple(b[k]), (k, a[k], b[k])


@pytest.mark.parametrize("name", NAMES)
def test_resolve_for_tp_equals_the_reference(name):
    for tp in TPS:
        got = dataclasses.asdict(resolve_for_tp(get_config(name), tp))
        want = dataclasses.asdict(jresolve(jget_config(name), tp))
        assert got == want, tp


def test_qwen3_at_tp4_keeps_its_published_heads():
    cfg = resolve_for_tp(get_config("qwen3-moe-30b-a3b"), 4)
    assert (cfg.heads, cfg.kv_heads) == (32, 4)


@pytest.mark.parametrize("name,size,tp", CELLS)
def test_param_and_opt_specs_equal_the_reference(name, size, tp):
    cfg, jcfg = _cfgs(name, size, tp)
    shapes = build_model(cfg).param_specs()
    jshapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0)))
    _same_shapes(shapes, jshapes)
    for fsdp in (True, False):
        got = shd.param_specs(cfg, shapes, tp, fsdp)
        want = jshd.param_specs(jcfg, jshapes, tp, fsdp)
        _same_specs(got, want)
    opt = shd.opt_specs(cfg, None, got)
    jopt = jshd.opt_specs(jcfg, None, want)
    assert opt.step == tuple(jopt.step)
    for field in ("mu", "nu", "master"):
        _same_specs(getattr(opt, field), getattr(jopt, field))


@pytest.mark.parametrize("name,size,tp", CELLS)
def test_cache_specs_equal_the_reference(name, size, tp):
    cfg, jcfg = _cfgs(name, size, tp)
    B, S = (4, 64) if size == "smoke" else (8, 4096)
    shapes = build_model(cfg).cache_specs(B, S)
    jshapes = jbuild(jcfg).cache_specs(B, S, stacked=False)
    _same_shapes(shapes, jshapes)
    for shardable in (True, False):
        _same_specs(shd.cache_specs(cfg, shapes, DP, tp, shardable),
                    jshd.cache_specs(jcfg, jshapes, DP, tp, shardable))


@pytest.mark.parametrize("name", NAMES)
def test_input_and_batch_specs_equal_the_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    for shape in SHAPES.values():
        got = build_model(cfg).input_specs(shape)
        want = jbuild(jcfg).input_specs(shape)
        _same_shapes(got, want)
        for shardable in (True, False):
            _same_specs(shd.batch_specs(got, ("pod", "data"), shardable),
                        jshd.batch_specs(want, ("pod", "data"), shardable))


def test_constants_equal_the_reference():
    assert shd.BATCH_AXES == jshd.BATCH_AXES
    assert shd.SEQ_SHARD_ACTIVATIONS == jshd.SEQ_SHARD_ACTIVATIONS


def test_activation_sharding_is_the_identity_outside_a_mesh():
    x = torch.randn(4, 8, 16)
    assert shd.active_mesh() is None
    assert shd.maybe_shard(x, "data", "model", None) is x
    assert shd.shard_activations(x) is x
    assert shd.shard_residual(x) is x
    assert shd.local_block(x, ("data", "model", None)) is x
    assert shd.axis_size("model") == 1 and shd.axis_index("model") == 0


def test_resolve_spec_drops_absent_and_nondividing_axes():
    class Mesh:                   # the two attributes the rule reads
        mesh_dim_names = ("data", "model")
        mesh = np.zeros((2, 4))

    spec = shd.resolve_spec((6, 8, 3), (("pod", "data"), "model", "model"),
                            Mesh())
    assert spec == ("data", "model", None)


def test_production_mesh_names_the_world_it_needs():
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs a world of {need}"):
            tmesh.make_production_mesh(multi_pod=multi_pod)

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert tmesh.dp_axes(Mesh()) == ("pod", "data")
