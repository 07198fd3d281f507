"""The port's training slice held against the JAX package:
recurrentgemma's smoke config in float32, on shared weights.

The weights are drawn once by the port's init on the CPU, handed to the
JAX model as numpy arrays and carried back with ``params_from_jax`` (as
``tests/test_torch_serve.py`` does); tokens come from the synthetic data
of each package at the same unit ids.  JAX runs jitted on the CPU; the
port runs its plain versions inside its ``autograd.Function``s, the path
a CPU tensor takes.

Tolerances:
* the loss at rtol and atol 1e-5 and every gradient leaf at 1e-4: float32
  arithmetic in another order (the associative scan and the chunked
  softmax against sequential loops), as ``tests/test_torch_serve.py``
  holds modules and logits;
* three AdamW updates on fixed gradients at 1e-6: the same float32
  operations, where ATen may fuse a multiply and an add;
* the schedules at rtol 1e-6: the same float32 operations, but XLA's and
  ATen's float32 cosines differ by an ulp on some inputs;
* ``remat`` bitwise: the backward recomputes the same operations;
* ``accum=2`` against ``accum=1`` at rtol 1e-5 (gradients also atol
  1e-6, for elements whose two halves cancel): the mean of two
  half-batch means against one mean, and the float32 sum of two halves;
* the three-step ``fit`` history at rtol 1e-4: the step's gradients
  differ as above, and Adam's first steps move every weight by about
  lr, whatever the gradient's size, so the loss after an update keeps
  the gradients' relative error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.train import loop as jloop
from repro_torch import data, optim
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loop

ARCH = "recurrentgemma-2b"
B, S = 2, 40                 # S past the smoke window of 16


def f32_smoke(get, smoke):
    return dataclasses.replace(smoke(get(ARCH)), dtype="float32")


@pytest.fixture(scope="module")
def slice_():
    jcfg = f32_smoke(jax_get_config, jax_smoke_config)
    cfg = f32_smoke(get_config, smoke_config)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), m.init(0, "cpu"))
    batch = data.structured_unit(3, B, S, cfg.vocab_size)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, drawn=drawn, batch=batch,
                jp=jax.tree.map(jnp.asarray, drawn))


def fresh(slice_):
    """A new copy of the shared weights on the port (steps train in
    place)."""
    return params_from_jax(slice_["drawn"], slice_["cfg"], "cpu")


def flat(tree, prefix=""):
    """{path: numpy leaf} of a dict tree of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def test_loss_and_every_gradient_leaf_match_jax(slice_):
    jm, batch = slice_["jm"], slice_["batch"]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, mode="scan", remat=False)[0]))(
            slice_["jp"], batch)
    loss, grads = loop.make_grad_step(slice_["m"], remat=False)(
        fresh(slice_), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    want, got = flat(jgrads), flat(grads)
    assert sorted(want) == sorted(got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                   atol=1e-4, err_msg=path)


def test_remat_equals_no_remat(slice_):
    params = fresh(slice_)
    (l0, g0), (l1, g1) = (loop.make_grad_step(slice_["m"], remat=r)(
        params, slice_["batch"]) for r in (False, True))
    assert torch.equal(l0, l1)
    for x, y in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(x, y)


def test_three_adamw_updates_match_jax():
    """A float32 and a bfloat16 leaf, gradients large enough to clip, a
    warmup-cosine rate: mu, nu, master and params after each update."""
    rng = np.random.default_rng(7)
    p0 = {"w": rng.standard_normal((4, 8)).astype(np.float32),
          "blk": {"g": rng.standard_normal(16).astype(np.float32)}}
    grads = [{"w": 3 * rng.standard_normal((4, 8)).astype(np.float32),
              "blk": {"g": rng.standard_normal(16).astype(np.float32)}}
             for _ in range(3)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    jopt = joptim.AdamW(lr=joptim.warmup_cosine(1e-2, 2, 10), **kw)
    opt = optim.AdamW(lr=optim.warmup_cosine(1e-2, 2, 10), **kw)
    jp = {"w": jnp.asarray(p0["w"]),
          "blk": {"g": jnp.asarray(p0["blk"]["g"], jnp.bfloat16)}}
    params = {"w": torch.from_numpy(p0["w"].copy()),
              "blk": {"g": torch.from_numpy(p0["blk"]["g"]).bfloat16()}}
    jstate, state = jopt.init(jp), opt.init(params)
    for g in grads:
        jg = {"w": jnp.asarray(g["w"]),
              "blk": {"g": jnp.asarray(g["blk"]["g"], jnp.bfloat16)}}
        tg = {"w": torch.from_numpy(g["w"]),
              "blk": {"g": torch.from_numpy(g["blk"]["g"]).bfloat16()}}
        jp, jstate = jopt.update(jg, jstate, jp)
        params, state = opt.update(tg, state, params)
        for got, want in [(state.mu, jstate.mu), (state.nu, jstate.nu),
                          (state.master, jstate.master), (params, jp)]:
            want, got = flat(want), flat(got)
            for path in want:
                np.testing.assert_allclose(got[path], want[path],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=path)
        assert params["blk"]["g"].dtype == torch.bfloat16
        assert torch.equal(params["blk"]["g"],
                           state.master["blk"]["g"].bfloat16())
    assert state.step == int(jstate.step) == 3


def test_schedules_match_jax():
    steps = np.arange(21)
    for ours, theirs in [(optim.warmup_cosine(3e-4, 5, 17, 1e-5),
                          joptim.warmup_cosine(3e-4, 5, 17, 1e-5)),
                         (optim.warmup_cosine(1.0, 0, 20),
                          joptim.warmup_cosine(1.0, 0, 20)),
                         (optim.constant(2e-3), joptim.constant(2e-3))]:
        got = np.array([float(ours(int(s))) for s in steps], np.float32)
        want = np.array([float(theirs(jnp.asarray(s, jnp.int32)))
                         for s in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


class KeepGrads:
    """An optimizer that keeps the gradients it is given and steps
    nothing: what ``make_train_step`` hands the update."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def test_accumulating_two_microbatches_equals_one_batch(slice_):
    runs = []
    for accum in (1, 2):
        opt = KeepGrads()
        step = loop.make_train_step(slice_["m"], opt, remat=False,
                                    accum=accum)
        _, _, metrics = step(fresh(slice_), None, slice_["batch"])
        runs.append((opt.grads, metrics))
    (g1, m1), (g2, m2) = runs
    for key in ("loss", "grad_norm", "xent"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                   rtol=1e-5, err_msg=key)
    for x, y in zip(tree_leaves(g2), tree_leaves(g1)):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_three_step_fit_history_matches_jax(slice_):
    store = dict(unit_batch=B, seq_len=S, vocab=slice_["cfg"].vocab_size,
                 structured=True)
    batches = [data.UnitStore(**store).fetch(u) for u in range(3)]
    jbatches = [jdata.UnitStore(**store).fetch(u) for u in range(3)]
    _, _, jhist = jloop.fit(slice_["jm"], slice_["jp"], joptim.AdamW(
        lr=joptim.constant(1e-3)), jbatches, log_every=1)
    _, state, hist = loop.fit(slice_["m"], fresh(slice_), optim.AdamW(
        lr=optim.constant(1e-3)), batches, log_every=1)
    assert state.step == 3 and [h["step"] for h in hist] == [0, 1, 2]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in jhist], rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("structured", [False, True])
def test_unit_content_is_byte_equal_to_jax_data(structured):
    store = data.UnitStore(3, 33, 1000, seed=5, structured=structured)
    jstore = jdata.UnitStore(3, 33, 1000, seed=5, structured=structured)
    fn = data.structured_unit if structured else data.unit_tokens
    jfn = jdata.structured_unit if structured else jdata.unit_tokens
    for unit in (0, 1, 17):
        for got, want in [(store.fetch(unit), jstore.fetch(unit)),
                          (fn(unit, 2, 9, 50, 4), jfn(unit, 2, 9, 50, 4))]:
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in got:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()
    assert store.tokens_per_unit() == jstore.tokens_per_unit() == 99
    loader = data.HetShardedLoader(store, 2)
    loader.prefetch(0, [0, 1])
    loader.assign(0, [1, 2])
    loader.touch(1, [2, 3])
    assert (loader.refetched_units, loader.refetched_tokens) == (3, 297)
