"""The port's unit-group gradient engine (``repro_torch.hettrain``) held
against the JAX package's ``ScanGradEngine``, on the CPU.

Two models, on weights drawn by the port's init and carried to JAX as
numpy arrays (as ``tests/test_torch_train.py`` does): the ``tiny``
preset of the training subsystem (phi3-mini's smoke config with
``MODEL_PRESETS["tiny"]`` dims, float32, vocab 128, units of 2 x 16
structured tokens, as ``TrainConfig()`` builds it) and granite-moe-
3b-a800m's smoke config in float32.  JAX folds the group with a jitted
``lax.scan``; the port loops over the units on its plain versions.

Tolerances: the gradient sums and the losses at rtol and atol 1e-4, as
``tests/test_torch_train.py`` holds one unit's gradients (float32 in
another order; a sum of a few units keeps that relative error).  Within
the port, order invariance and padding are bitwise: the ids are sorted
before anything is computed, and no pad slot adds a bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import UnitStore as JaxUnitStore
from repro.hettrain import ScanGradEngine as JaxEngine
from repro.hettrain import tree_bytes as jax_tree_bytes
from repro.hettrain.config import MODEL_PRESETS, TrainConfig
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import UnitStore
from repro_torch.hettrain import (MIN_BUCKET, ScanGradEngine, bucket_units,
                                  tree_bytes)
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves

TRAIN = TrainConfig()
MODELS = {
    "tiny": ("phi3-mini-3.8b", dict(vocab_size=TRAIN.vocab,
                                    **MODEL_PRESETS[TRAIN.model])),
    "granite-moe": ("granite-moe-3b-a800m", {}),
}
GROUPS = ([2, 0], [3, 1, 4])


def build(name):
    arch, kw = MODELS[name]
    jcfg, cfg = (dataclasses.replace(smoke(get(arch)), dtype="float32", **kw)
                 for get, smoke in ((jax_get_config, jax_smoke_config),
                                    (get_config, smoke_config)))
    m = build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), m.init(TRAIN.init_seed, "cpu"))
    store = dict(unit_batch=TRAIN.unit_batch, seq_len=TRAIN.seq_len,
                 vocab=min(TRAIN.vocab, cfg.vocab_size),
                 seed=TRAIN.data_seed, structured=True)
    return dict(m=m, jm=jax_build_model(jcfg), drawn=drawn,
                params=params_from_jax(drawn, cfg, "cpu"),
                jp=jax.tree.map(jnp.asarray, drawn),
                store=UnitStore(**store), jstore=JaxUnitStore(**store))


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request):
    return build(request.param)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


def test_bucket_table_is_the_reference_table():
    assert MIN_BUCKET == 4
    assert [bucket_units(n) for n in (1, 3, 4, 5, 8, 9, 16, 17)] == \
        [4, 4, 4, 8, 8, 16, 16, 32]
    assert bucket_units(3, min_bucket=1) == 4
    assert bucket_units(2, min_bucket=1) == 2
    with pytest.raises(ValueError):
        bucket_units(0)


def test_grad_sum_and_losses_match_the_jax_engine(setup):
    eng = ScanGradEngine(setup["m"], setup["store"])
    jeng = JaxEngine(setup["jm"], setup["jstore"])
    for ids in GROUPS:
        grads, losses = eng.grad_sum(setup["params"], ids)
        jgrads, jlosses = jeng.grad_sum(setup["jp"], ids)
        assert losses.dtype == np.float32 and losses.shape == (len(ids),)
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
        got, want = flat(grads), flat(jgrads)
        assert sorted(got) == sorted(want)
        for path in want:
            assert got[path].dtype == np.float32
            np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                       atol=1e-4, err_msg=path)
    assert eng.stats() == jeng.stats() == {
        "dispatches": 2, "units": 5, "bucket_sizes": [4]}


def test_order_invariance_is_bitwise(setup):
    eng = ScanGradEngine(setup["m"], setup["store"])
    a, la = eng.grad_sum(setup["params"], [4, 1, 3, 0, 2])
    b, lb = eng.grad_sum(setup["params"], list(range(5)))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert np.array_equal(la, lb)


def test_padding_adds_no_bit(setup):
    padded = ScanGradEngine(setup["m"], setup["store"], min_bucket=4)
    exact = ScanGradEngine(setup["m"], setup["store"], min_bucket=1)
    a, la = padded.grad_sum(setup["params"], [0, 1])
    b, lb = exact.grad_sum(setup["params"], [0, 1])
    assert padded.stats()["bucket_sizes"] == [4]
    assert exact.stats()["bucket_sizes"] == [2]
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert np.array_equal(la, lb)


def test_stats_match_the_jax_engine_after_the_same_calls(setup):
    """The counters after groups of 1, 3 and 5 units at a floor of 2.
    They are kept on the host, so the JAX engine's jitted scan is stubbed
    out here (``test_grad_sum_and_losses_match_the_jax_engine`` runs it)."""
    eng = ScanGradEngine(setup["m"], setup["store"], min_bucket=2)
    jeng = JaxEngine(setup["jm"], setup["jstore"], min_bucket=2)
    jeng._jit = lambda params, toks, labels, mask: (
        params, np.zeros(mask.shape, np.float32))
    for ids in ([0], [1, 2, 3], [4, 5, 6, 7, 8]):
        eng.grad_sum(setup["params"], ids)
        jeng.grad_sum(setup["jp"], ids)
    assert eng.stats() == jeng.stats() == {
        "dispatches": 3, "units": 9, "bucket_sizes": [2, 4, 8]}


def test_tree_bytes_match(setup):
    assert tree_bytes(setup["params"]) == jax_tree_bytes(setup["jp"])
    half = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "b": {"c": torch.zeros(7)}}
    assert tree_bytes(half) == 3 * 5 * 2 + 7 * 4
