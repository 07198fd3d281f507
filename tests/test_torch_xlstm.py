"""The port's xLSTM (xlstm-350m's mLSTM and sLSTM blocks) held against
the JAX package at xlstm's smoke config in float32 (one mLSTM and one
sLSTM layer a period, two periods), on shared weights
(``tests/torch_zoo.py``).

Modules at rtol and atol 1e-5: ``_mlstm_chunk_scan`` below the chunk
(S 40) and at two whole chunks (S 512) on the inputs the model's first
mLSTM layer makes, its final state, and its gradients (the port
checkpoints each chunk's body when autograd records it) at 1e-4;
``mlstm_forward`` and ``slstm_forward`` with their states; the decode
steps of both cells carried from those states.  The loss at
1e-5 and every gradient leaf at 1e-4; prefill and decode logits at 1e-4
and greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo import (check_loss_and_grads, check_serving, close,
                       close_tree, hard_limit, pair, t)

from repro.models import xlstm as jxl
from repro_torch.models import xlstm as xl
from repro_torch.models.transformer import _index

__all__ = ["hard_limit"]

ARCH = "xlstm-350m"
B = 2


@pytest.fixture(scope="module")
def xlstm():
    return pair(ARCH)


def cell(p, key):
    """(JAX, port) params of layer 0 of body block ``key`` (b0 mLSTM, b1
    sLSTM)."""
    return (jax.tree.map(lambda x: x[0], p["jp"]["body"][key])["cell"],
            _index(p["params"]["body"][key], 0)["cell"])


def chunk_inputs(p, S, seed=0):
    """The chunk scan's inputs as the smoke model's first mLSTM layer
    makes them from a (B, S, D) normal input: q, k, v (B, H, S, dh) and
    log_i, log_f (B, H, S), as numpy."""
    cfg = p["cfg"]
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    _, pt = cell(p, "b0")
    with torch.no_grad():
        _, _, _, q, k, v, log_i, log_f, _ = xl._mlstm_in(pt, cfg, t(x))
    H = cfg.heads

    def heads(a):
        return a.reshape(B, S, H, -1).transpose(1, 2).numpy()

    return (heads(q), heads(k), heads(v), log_i.transpose(1, 2).numpy(),
            log_f.transpose(1, 2).numpy())


def test_the_stack_is_mlstm_then_slstm(xlstm):
    cfg = xlstm["cfg"]
    assert cfg.layer_kinds() == ("mlstm", "slstm") * 2
    assert sorted(xlstm["params"]["body"]) == ["b0", "b1"]
    assert xlstm["params"]["body"]["b0"]["cell"]["w_if"].dtype == \
        torch.float32


@pytest.mark.parametrize("S", [40, 2 * xl.MLSTM_CHUNK])
def test_mlstm_chunk_scan_and_its_state_match_jax(xlstm, S):
    args = chunk_inputs(xlstm, S, seed=S)
    h, (C, n, m) = xl._mlstm_chunk_scan(*(t(a) for a in args))
    hj, (Cj, nj, mj) = jax.jit(jxl._mlstm_chunk_scan)(
        *(jnp.asarray(a) for a in args))
    close(h, hj)
    close(C, Cj)
    close(n, nj)
    close(m, mj)


def test_mlstm_chunk_scan_gradients_match_jax(xlstm):
    """Two chunks, so the carry crosses a checkpointed chunk boundary."""
    S = 2 * xl.MLSTM_CHUNK
    args = chunk_inputs(xlstm, S, seed=3)
    cot = np.random.default_rng(4).standard_normal(
        args[0].shape).astype(np.float32)

    def jloss(*a):
        h, (C, _, _) = jxl._mlstm_chunk_scan(*a)
        return jnp.sum(h * cot) + jnp.sum(C)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in args))
    ts = [t(a).requires_grad_() for a in args]
    h, (C, _, _) = xl._mlstm_chunk_scan(*ts)
    got = torch.autograd.grad((h * t(cot)).sum() + C.sum(), ts)
    for g, w, name in zip(got, want, ["q", "k", "v", "log_i", "log_f"]):
        close(g, w, 1e-4, name)


def test_chunk_scan_refuses_a_ragged_sequence(xlstm):
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk"):
        xl._mlstm_chunk_scan(*(t(a) for a in chunk_inputs(xlstm, 300)))


def test_mlstm_forward_state_and_decode_match_jax(xlstm):
    cfg, jcfg = xlstm["cfg"], xlstm["jcfg"]
    pj, pt = cell(xlstm, "b0")
    x = np.random.default_rng(5).standard_normal(
        (B, 15, cfg.d_model)).astype(np.float32)
    y, st = xl.mlstm_forward(pt, cfg, t(x[:, :12]), return_state=True)
    yj, stj = jax.jit(jxl.mlstm_forward, static_argnums=(1, 3))(
        pj, jcfg, jnp.asarray(x[:, :12]), True)
    close(y, yj)
    close_tree(st, stj)
    jdecode = jax.jit(jxl.mlstm_decode, static_argnums=1)
    for s in range(12, 15):
        y, st = xl.mlstm_decode(pt, cfg, t(x[:, s:s + 1]), st)
        yj, stj = jdecode(pj, jcfg, jnp.asarray(x[:, s:s + 1]), stj)
        close(y, yj)
        close_tree(st, stj)
    # a prompt shorter than the conv's window pads its state
    _, st = xl.mlstm_forward(pt, cfg, t(x[:, :2]), return_state=True)
    _, stj = jxl.mlstm_forward(pj, jcfg, jnp.asarray(x[:, :2]), True)
    close(st["conv"], stj["conv"])


def test_slstm_forward_state_and_decode_match_jax(xlstm):
    cfg, jcfg = xlstm["cfg"], xlstm["jcfg"]
    pj, pt = cell(xlstm, "b1")
    x = np.random.default_rng(6).standard_normal(
        (B, 13, cfg.d_model)).astype(np.float32)
    close(xl.slstm_forward(pt, cfg, t(x)),
          jxl.slstm_forward(pj, jcfg, jnp.asarray(x)))
    y, st = xl.slstm_forward(pt, cfg, t(x[:, :10]), return_state=True)
    yj, stj = jax.jit(jxl.slstm_forward, static_argnums=(1, 3))(
        pj, jcfg, jnp.asarray(x[:, :10]), True)
    close(y, yj)
    close_tree(st, stj)
    jdecode = jax.jit(jxl.slstm_decode, static_argnums=1)
    for s in range(10, 13):
        y, st = xl.slstm_decode(pt, cfg, t(x[:, s:s + 1]), st)
        yj, stj = jdecode(pj, jcfg, jnp.asarray(x[:, s:s + 1]), stj)
        close(y, yj)
        close_tree(st, stj)


def test_loss_and_every_gradient_leaf_match_jax(xlstm):
    cfg = xlstm["cfg"]
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, 25))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    assert np.isfinite(check_loss_and_grads(xlstm, batch))


def test_remat_is_bitwise_the_plain_backward(xlstm):
    """Recomputing each period in the backward (and each mLSTM chunk,
    always) gives the same bits as keeping the activations."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import loop
    cfg = xlstm["cfg"]
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (B, 25))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (l0, g0), (l1, g1) = (loop.make_grad_step(xlstm["m"], remat=r)(
        xlstm["params"], batch) for r in (False, True))
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_prefill_decode_logits_and_greedy_tokens_match_jax(xlstm):
    cfg = xlstm["cfg"]
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 20))
    check_serving(xlstm, {"tokens": toks[:, :14]}, toks[:, 14:], 24, 6)
