"""The port's encoder-decoder (seamless-m4t-medium's backbone) held
against the JAX package at its smoke config in float32, on shared
weights (``tests/torch_zoo.py``): ``encode`` and ``_cross_attn`` at
rtol and atol 1e-5, ``layernorm`` and ``gelu_mlp`` likewise, the loss at
1e-5 and every gradient leaf at 1e-4 (with each decoder layer
recomputed, bitwise the same), prefill and decode logits at 1e-4 and
greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo import (check_loss_and_grads, check_serving, close, hard_limit,
                       pair, t)

from repro.models import common as jcommon
from repro.models import encdec as jed
from repro_torch.models import common, encdec
from repro_torch.models.transformer import _index

__all__ = ["hard_limit"]

ARCH = "seamless-m4t-medium"
B = 2


@pytest.fixture(scope="module")
def ed():
    return pair(ARCH)


def frames(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_layernorm_and_gelu_mlp_match_jax(ed):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 5, 64)).astype(np.float32)
    g, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    close(common.layernorm(t(x), t(g), t(b)), jcommon.layernorm(x, g, b))
    pj = jax.tree.map(lambda a: a[0], ed["jp"]["enc"])["mlp"]
    pt = _index(ed["params"]["enc"], 0)["mlp"]
    close(common.gelu_mlp(pt, t(x)), jcommon.gelu_mlp(pj, x))


@pytest.mark.parametrize("S", [7, 20])
def test_encode_matches_jax(ed, S):
    cfg, jcfg = ed["cfg"], ed["jcfg"]
    f = frames(cfg, S, S)
    close(encdec.encode(ed["params"], cfg, t(f)),
          jax.jit(jed.encode, static_argnums=(1, 3))(ed["jp"], jcfg,
                                                      jnp.asarray(f), "scan"))


def test_cross_attn_matches_jax(ed):
    cfg, jcfg = ed["cfg"], ed["jcfg"]
    pj = jax.tree.map(lambda a: a[1], ed["jp"]["dec"])["cross"]
    pt = _index(ed["params"]["dec"], 1)["cross"]
    x = frames(cfg, 5, 3)
    enc_out = frames(cfg, 11, 4)
    close(encdec._cross_attn(pt, cfg, t(x), t(enc_out)),
          jed._cross_attn(pj, jcfg, jnp.asarray(x), jnp.asarray(enc_out)))
    # the decode-time form over cached keys and values agrees with it
    k, v = encdec._cross_kv(pt, cfg, t(enc_out))
    close(encdec._cross_attn_cached(pt, cfg, t(x[:, :1]), {"k": k, "v": v}),
          jed._cross_attn(pj, jcfg, jnp.asarray(x[:, :1]),
                          jnp.asarray(enc_out)))


def batch(cfg, S_src, S_tgt, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S_tgt + 1))
    return {"frame_embeds": frames(cfg, S_src, seed + 1),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_loss_and_every_gradient_leaf_match_jax(ed):
    assert np.isfinite(check_loss_and_grads(ed, batch(ed["cfg"], 14, 9, 7)))


def test_remat_is_bitwise_the_plain_backward(ed):
    """Recomputing each decoder layer in the backward gives the same bits
    as keeping its activations."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import loop
    b = batch(ed["cfg"], 14, 9, 8)
    (l0, g0), (l1, g1) = (loop.make_grad_step(ed["m"], remat=r)(
        ed["params"], b) for r in (False, True))
    assert torch.equal(l0, l1)
    for x, y in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(x, y)


def test_prefill_decode_logits_and_greedy_tokens_match_jax(ed):
    cfg = ed["cfg"]
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 10))
    prompt = {"frame_embeds": frames(cfg, 16, 13), "tokens": toks[:, :4]}
    check_serving(ed, prompt, toks[:, 4:], 24, 6)


def test_the_cache_keeps_the_stacked_layout(ed):
    cfg = ed["cfg"]
    m, params = ed["m"], ed["params"]
    prompt = {"frame_embeds": t(frames(cfg, 16, 13)),
              "tokens": torch.zeros((B, 4), dtype=torch.long)}
    cache = m.init_cache(B, 24, "cpu")
    assert cache["self"]["k"].shape == (cfg.n_dec_layers, B, 24,
                                        cfg.kv_heads, cfg.hd)
    _, cache = m.prefill(params, prompt, cache)
    assert cache["pos"] == 4
    assert cache["cross"]["k"].shape == (cfg.n_dec_layers, B, 16,
                                         cfg.heads, cfg.hd)
    before = cache["self"]["k"].clone()
    _, cache2 = m.decode_step(params, cache, torch.zeros((B, 1),
                                                         dtype=torch.long))
    assert cache2["pos"] == 5
    assert torch.equal(cache2["self"]["k"][:, :, :4], before[:, :, :4])
    assert not torch.equal(cache2["self"]["k"][:, :, 4], before[:, :, 4])


def test_serve_launcher_draws_the_reference_requests(ed):
    """``launch.serve.prompt_batch``: the JAX launcher's frames, then 4
    tokens, from ``default_rng(0)``."""
    from repro_torch.launch.serve import prompt_batch
    cfg = ed["cfg"]
    got = prompt_batch(cfg, 3, 10, "cpu")
    rng = np.random.default_rng(0)
    frames_ = rng.normal(size=(3, 10, cfg.d_model))
    toks = rng.integers(0, cfg.vocab_size, (3, 4))
    assert sorted(got) == ["frame_embeds", "tokens"]
    np.testing.assert_array_equal(got["frame_embeds"].numpy(),
                                  frames_.astype(np.float32))
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
