"""The port's MoE training held against the JAX package: granite-moe-
3b-a800m's smoke config in float32, on shared weights.

The weights are drawn once by the port's init on the CPU, handed to the
JAX model as numpy arrays and carried back with ``params_from_jax`` (as
``tests/test_torch_train.py`` does for recurrentgemma); tokens come from
the synthetic data of each package at the same unit ids.  JAX runs
jitted on the CPU (its MoE computes the expert products with einsum);
the port runs its plain versions inside its ``autograd.Function``s, the
path a CPU tensor takes.

The smoke config sets the capacity factor to the expert count, so it
drops no (token, k) pair.  The published 1.25 is tested too, on a batch
where pairs are dropped: a dropped pair's row goes to the trash row of
the dispatch buffer and reads back as zero, and its gradient must be
exactly zero, as under the JAX ``.at[slot].add`` and gather.

Tolerances, as ``tests/test_torch_train.py`` holds the dense slice:
* the loss and both metrics at rtol and atol 1e-5, and every gradient
  leaf (the float32 router included) at 1e-4: float32 arithmetic in
  another order (einsum against a batched product; a softmax and a mean
  in ATen's order against XLA's).  The routing, the slot ranks and so
  the dropped pairs are equal on both sides;
* ``remat`` bitwise: the backward recomputes the same operations;
* the three-step ``fit`` history at rtol 1e-4: Adam's first steps move
  every weight by about lr whatever the gradient's size, so the loss
  after an update keeps the gradients' relative error.
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
from repro_torch import data, optim
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.moe_gmm import expert_matmul
from repro_torch.models import build_model, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loop

ARCH = "granite-moe-3b-a800m"
B, S = 2, 24
# at the published capacity factor, one 24-token sequence of unit 3 gets
# C = 16 and its first layer drops 1 of 48 (token, k) pairs
PUBLISHED_CAPACITY, B_DROP = 1.25, 1


def f32_smoke(get, smoke, **kw):
    return dataclasses.replace(smoke(get(ARCH)), dtype="float32", **kw)


def build(batch_rows, **kw):
    jcfg = f32_smoke(jax_get_config, jax_smoke_config, **kw)
    cfg = f32_smoke(get_config, smoke_config, **kw)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), m.init(0, "cpu"))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, drawn=drawn, B=batch_rows,
                batch=data.structured_unit(3, batch_rows, S, cfg.vocab_size),
                jp=jax.tree.map(jnp.asarray, drawn))


@pytest.fixture(scope="module")
def slice_():
    return build(B)


@pytest.fixture(scope="module")
def dropping():
    return build(B_DROP, capacity_factor=PUBLISHED_CAPACITY)


def fresh(s):
    """A new copy of the shared weights on the port (steps train in
    place)."""
    return params_from_jax(s["drawn"], s["cfg"], "cpu")


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


def dropped_share(s):
    """Share of (token, k) pairs the first layer drops, on the port."""
    params, cfg = fresh(s), s["cfg"]
    x = params["embed"][torch.as_tensor(s["batch"]["tokens"]).long()]
    layer = {k: v[0] for k, v in params["body"]["b0"]["mlp"].items()}
    _, _, keep, _, _ = moe.route(layer, cfg, x)
    return float((~keep).float().mean())


def check_against_jax(s):
    jm, batch = s["jm"], s["batch"]
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, mode="scan", remat=False),
        has_aux=True))(s["jp"], batch)
    loss, metrics = s["m"].loss(fresh(s), loop._on_device(
        batch, torch.device("cpu")))
    for got, want in [(loss, jloss), (metrics["xent"], jmetrics["xent"]),
                      (metrics["moe_aux"], jmetrics["moe_aux"])]:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)
    gloss, grads = loop.make_grad_step(s["m"], remat=False)(fresh(s), batch)
    assert float(gloss) == float(loss)
    want, got = flat(jgrads), flat(grads)
    assert sorted(want) == sorted(got)
    assert "body.b0.mlp.router" in got
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                   atol=1e-4, err_msg=path)


def test_loss_metrics_and_every_gradient_leaf_match_jax(slice_):
    assert dropped_share(slice_) == 0.0
    check_against_jax(slice_)


def test_xent_metric_includes_the_aux_term_as_in_the_reference(slice_):
    """The JAX ``lm_loss`` rebinds ``loss`` to ``loss + aux_weight * aux``
    before it builds the metrics, so its ``"xent"`` is the total loss;
    the port matches it."""
    batch = loop._on_device(slice_["batch"], torch.device("cpu"))
    loss, metrics = slice_["m"].loss(fresh(slice_), batch)
    assert float(metrics["moe_aux"]) > 0
    assert torch.equal(metrics["xent"], loss)


def test_published_capacity_drops_pairs_and_matches_jax(dropping):
    assert dropped_share(dropping) > 0.0
    check_against_jax(dropping)


def test_dropped_pairs_get_exactly_zero_gradient(dropping, monkeypatch):
    """Through the first MoE layer at the published capacity, on the
    batch's embeddings: the dispatch's gradient into x is, for each token,
    exactly the sum of its kept pairs' slot rows (a dropped pair's row
    went to the trash row, which is cut off); the combine's gradient into
    the expert output buffer is, in each kept pair's slot, exactly that
    pair's cotangent times its router weight, and exactly zero in every
    other row (the rows the dropped pairs' gathers read too)."""
    cfg = dropping["cfg"]
    E, K, T = cfg.n_experts, cfg.experts_per_token, dropping["B"] * S
    params = fresh(dropping)
    layer = {k: v[0] for k, v in params["body"]["b0"]["mlp"].items()}
    x = params["embed"][torch.as_tensor(
        dropping["batch"]["tokens"]).long()].requires_grad_()
    ins, outs = [], []

    def recording(buf, w):
        y = expert_matmul(buf, w)
        y.retain_grad()
        ins.append(buf)
        outs.append(y)
        return y

    monkeypatch.setattr(moe, "expert_matmul", recording)
    out, _ = moe.moe_apply(layer, cfg, x)
    top_p, slot, keep, C, _ = moe.route(layer, cfg, x.detach())
    assert 0 < int((~keep).sum()) and int(keep.sum()) > 0
    gen = torch.Generator().manual_seed(0)
    g_buf = torch.randn(ins[0].shape, generator=gen)
    (g_x,) = torch.autograd.grad(ins[0], x, g_buf, retain_graph=True)
    rows = torch.cat([g_buf.reshape(E * C, -1),
                      torch.zeros((1, cfg.d_model))])[slot]
    want_x = torch.where(keep[:, None], rows, 0.0).reshape(T, K, -1).sum(1)
    assert torch.equal(g_x.reshape(T, -1), want_x)
    cot = torch.randn(out.shape, generator=gen)
    (out * cot).sum().backward()
    pair_cot = cot.reshape(T, 1, -1) * top_p.reshape(T, K, 1)
    want = torch.zeros((E * C, cfg.d_model)).index_copy_(
        0, slot[keep], pair_cot.reshape(T * K, -1)[keep])
    assert torch.equal(outs[2].grad.reshape(E * C, -1), want)


def test_remat_equals_no_remat(dropping):
    params = fresh(dropping)
    (l0, g0), (l1, g1) = (loop.make_grad_step(dropping["m"], remat=r)(
        params, dropping["batch"]) for r in (False, True))
    assert torch.equal(l0, l1)
    for x, y in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(x, y)


def test_three_step_fit_history_matches_jax(dropping):
    cfg = dropping["cfg"]
    store = dict(unit_batch=B_DROP, seq_len=S, vocab=cfg.vocab_size,
                 structured=True)
    batches = [data.UnitStore(**store).fetch(u) for u in range(3)]
    jbatches = [jdata.UnitStore(**store).fetch(u) for u in range(3)]
    from repro.train import loop as jloop
    _, _, jhist = jloop.fit(dropping["jm"], dropping["jp"], joptim.AdamW(
        lr=joptim.constant(1e-3)), jbatches, log_every=1)
    _, state, hist = loop.fit(dropping["m"], fresh(dropping), optim.AdamW(
        lr=optim.constant(1e-3)), batches, log_every=1)
    assert state.step == 3 and [h["step"] for h in hist] == [0, 1, 2]
    for key in ("loss", "grad_norm", "xent", "moe_aux"):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in jhist], rtol=1e-4,
                                   err_msg=key)
