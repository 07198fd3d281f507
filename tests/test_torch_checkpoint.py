"""The port's checkpointing (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): one on-disk format.

* A round trip is bitwise, bfloat16 leaves included, and keeps the
  tree's structure, types, dtypes and ``extra``.
* Keep-last-3 retention holds, and no ``.tmp_`` directory is left.
* The leaf order is ``jax.tree.flatten``'s, so a float32 ``(params,
  opt_state)`` written by the JAX package restores into the port, and
  one written by the port into the JAX package, both bit for bit.
* ``reshard_rates`` is the reference's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo import hard_limit

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

__all__ = ["hard_limit"]

ARCH = "recurrentgemma-2b"


def mixed_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    p = {"w": torch.randn((3, 5), generator=g),
         "blk": {"g": torch.randn(7, generator=g).bfloat16(),
                 "b": torch.randn((2, 2), generator=g)},
         "emb": torch.randn((4, 3), generator=g).bfloat16()}
    st = optim.AdamWState(step=3, mu={k: v for k, v in p.items()},
                          nu=None, master=[p["w"] * 2, 1.5])
    return {"params": p, "state": st, "ids": np.arange(5, dtype=np.int32)}


def zeros_like(tree):
    if isinstance(tree, dict):
        return {k: zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zeros_like(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(zeros_like(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree)
    return None if tree is None else type(tree)(0)


def assert_bitwise(got, want):
    g, w = flatten(got), flatten(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b)
        else:
            np.testing.assert_array_equal(a, b)


def test_round_trip_is_bitwise_with_bf16_leaves(tmp_path):
    tree = mixed_tree()
    path = ckpt.save_checkpoint(tmp_path, 7, tree, extra={"step": 7,
                                                          "note": "x"})
    assert path.name == "step_00000007"
    got, extra = ckpt.restore_checkpoint(path, zeros_like(tree))
    assert extra == {"step": 7, "note": "x"}
    assert isinstance(got["state"], optim.AdamWState)
    assert got["state"].nu is None and got["state"].step == 3
    assert list(got["params"]) == list(tree["params"])
    assert_bitwise(got, tree)
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["n_leaves"] == len(flatten(tree)) == 12
    assert manifest["treedef"].startswith("{ids: *, params: {blk: {b: *")
    with np.load(path / "arrays.npz") as data:
        assert data["a3"].dtype == np.dtype("V2")      # params.blk.g


def test_restore_checks_structure_and_shapes(tmp_path):
    tree = mixed_tree()
    path = ckpt.save_checkpoint(tmp_path, 0, tree)
    fewer = dict(tree, ids=None)
    with pytest.raises(ValueError, match="structure changed"):
        ckpt.restore_checkpoint(path, fewer)
    wrong = zeros_like(tree)
    wrong["params"]["w"] = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(path, wrong)


def test_keep_last_three_and_no_tmp_left(tmp_path):
    tree = {"x": torch.arange(4.0)}
    assert ckpt.latest_checkpoint(tmp_path / "none") is None
    for step in range(6):
        ckpt.save_checkpoint(tmp_path, step, tree, extra={"step": step})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000003", "step_00000004", "step_00000005"]
    assert ckpt.latest_checkpoint(tmp_path).name == "step_00000005"
    ckpt.save_checkpoint(tmp_path, 5, {"x": torch.ones(4)})   # overwrite
    got, _ = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path), tree)
    assert torch.equal(got["x"], torch.ones(4))
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp_")]


def test_leaf_order_is_jax_tree_flatten():
    tree = mixed_tree()
    as_np = jax.tree.map(
        lambda x: x.float().numpy() if isinstance(x, torch.Tensor) else x,
        tree)
    jleaves = jax.tree.leaves(as_np)
    ours = flatten(tree)
    assert len(jleaves) == len(ours)
    for a, b in zip(ours, jleaves):
        np.testing.assert_array_equal(
            a.float().numpy() if isinstance(a, torch.Tensor) else a, b)


@pytest.fixture(scope="module")
def states():
    """The same float32 smoke params and one AdamW update of them in both
    packages."""
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                              dtype="float32")
    drawn = jax.tree.map(lambda x: x.numpy(),
                         build_model(cfg).init(0, "cpu"))
    grads = jax.tree.map(
        lambda x: np.random.default_rng(x.size).standard_normal(
            x.shape).astype(np.float32), drawn)
    jopt = joptim.AdamW(lr=1e-2)
    jp = jax.tree.map(jnp.asarray, drawn)
    jp, jst = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, grads),
                                   jopt.init(jp), jp)
    opt = optim.AdamW(lr=1e-2)
    params = params_from_jax(drawn, cfg, "cpu")
    st = opt.init(params)
    params, st = opt.update(params_from_jax(grads, cfg, "cpu"), st, params)
    return dict(jtree=(jp, jst), tree=(params, st), like=(
        params_from_jax(drawn, cfg, "cpu"), opt.init(params)))


def test_a_jax_checkpoint_restores_into_the_port_bitwise(tmp_path, states):
    jckpt.save_checkpoint(tmp_path, 4, states["jtree"], extra={"step": 4})
    (params, st), extra = ckpt.restore_checkpoint(
        ckpt.latest_checkpoint(tmp_path), states["like"])
    assert extra == {"step": 4}
    assert st.step == 1 and isinstance(st.step, int)
    got = flatten((params, st))
    want = jax.tree.leaves(states["jtree"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert a == int(b)


def test_a_port_checkpoint_restores_into_jax_bitwise(tmp_path, states):
    ckpt.save_checkpoint(tmp_path, 4, states["tree"], extra={"step": 4})
    jtree, extra = jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(tmp_path), states["jtree"])
    assert extra == {"step": 4}
    got = jax.tree.leaves(jtree)
    want = flatten(states["tree"])
    assert jax.tree.structure(jtree) == jax.tree.structure(states["jtree"])
    for a, b in zip(got, want):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(np.asarray(a), b)
    # and the port's params are the ones the JAX update gave, to float32
    # rounding of another order
    for a, b in zip(jax.tree.leaves(states["jtree"][0]),
                    jax.tree.leaves(jtree[0])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("rates,k", [([3.0, 1.0, 2.0], 2),
                                     ([3.0, 1.0, 2.0], 5),
                                     ([3.0, 1.0, 2.0], 3), ([], 2)])
def test_reshard_rates_is_the_reference(rates, k):
    got = ckpt.reshard_rates(np.array(rates), k)
    want = jckpt.reshard_rates(np.array(rates), k)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
