"""The port's serving slice held against the JAX package: recurrentgemma
at its smoke config in float32, module by module and end to end.

Both models run on the same weights (see the ``slice_`` fixture); token
and activation inputs are made with numpy from fixed seeds.  JAX runs on the CPU (jitted, as its serving path runs);
the port runs its plain versions, the path a CPU tensor takes.

Tolerances: single modules rtol and atol 1e-5 (float32 arithmetic in
another order); whole-model logits rtol and atol 1e-4, as
``tests/test_models_smoke.py`` holds the JAX package's own cache paths to
its forward pass.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import common as jcommon
from repro.models import recurrent as jrec
from repro.models import transformer as jtf
from repro.train.serve import greedy_generate as jax_greedy_generate
from repro.train.serve import make_decode_step, make_prefill_step
from repro_torch.configs import get_config, list_configs, smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model, common
from repro_torch.models import recurrent as rec
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.train.serve import greedy_generate

ARCH = "recurrentgemma-2b"
MOD_TOL = 1e-5
LOGIT_TOL = 1e-4
B, S_TOTAL = 2, 44
jax_gqa_decode = jax.jit(jattn.gqa_decode, static_argnums=(1, 5))


def f32_smoke(get, smoke):
    return dataclasses.replace(smoke(get(ARCH)), dtype="float32")


@pytest.fixture(scope="module")
def slice_():
    """Both models on the same weights, and JAX's teacher-forced logits of
    every position of a (B, 44) token run.  The weights are drawn once by
    the port's init on the CPU, handed to the JAX model as numpy arrays
    in the layout ``jax.eval_shape(init)`` gives, and carried back onto
    the port with ``params_from_jax``."""
    jcfg = f32_smoke(jax_get_config, jax_smoke_config)
    cfg = f32_smoke(get_config, smoke_config)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), m.init(0, "cpu"))
    layout = jax.eval_shape(jm.init, jax.random.key(0))
    assert jax.tree.structure(drawn) == jax.tree.structure(layout)
    assert jax.tree.map(np.shape, drawn) == jax.tree.map(
        lambda s: s.shape, layout)
    jp = jax.tree.map(jnp.asarray, drawn)
    params = params_from_jax(drawn, cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, S_TOTAL))

    @jax.jit
    def forward_logits(p, tokens):
        h = jtf._embed_tokens(p, jcfg, {"tokens": tokens})
        h, _ = jtf.forward_hidden(p, jcfg, h, mode="scan")
        return jcommon.rmsnorm(h, p["final_norm"], jcfg.norm_eps) \
            @ p["lm_head"]

    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, m=m, params=params,
                toks=toks, drawn=drawn,
                forward=np.asarray(forward_logits(jp, jnp.asarray(toks))),
                jprefill=jax.jit(make_prefill_step(jm)),
                jdecode=jax.jit(make_decode_step(jm)))


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(ours, want, tol=MOD_TOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def layer(tree, kind_key, j=0):
    """Layer j of the stacked body block ``kind_key`` (b0 rec, b2 attn)."""
    return jax.tree.map(lambda x: x[j], tree["body"][kind_key])


def port_layer(tree, kind_key, j=0):
    return transformer._index(tree["body"][kind_key], j)


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

def test_common_blocks_match_jax(slice_):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 7, 64)).astype(np.float32)
    gamma = rng.standard_normal(64).astype(np.float32)
    close(common.rmsnorm(t(x), t(gamma)), jcommon.rmsnorm(x, gamma))
    xr = rng.standard_normal((B, 7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10)[None, :]
    close(common.apply_rope(t(xr), t(pos), 10_000.0),
          jcommon.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 10_000.0))
    mlp_j = layer(slice_["jp"], "b0")["mlp"]
    mlp_t = port_layer(slice_["params"], "b0")["mlp"]
    close(common.swiglu(mlp_t, t(x)), jcommon.swiglu(mlp_j, x))


def test_rglru_pieces_match_jax(slice_):
    cfg, jcfg = slice_["cfg"], slice_["jcfg"]
    pj = layer(slice_["jp"], "b0")["rec"]
    pt = port_layer(slice_["params"], "b0")["rec"]
    rng = np.random.default_rng(3)
    u = rng.standard_normal((B, 9, cfg.lru_width)).astype(np.float32)
    state = rng.standard_normal((B, cfg.conv_width - 1,
                                 cfg.lru_width)).astype(np.float32)
    for st in (None, state):
        y, ns = rec._causal_conv(t(u), pt["conv_w"],
                                 None if st is None else t(st))
        yj, nsj = jrec._causal_conv(jnp.asarray(u), pj["conv_w"],
                                    None if st is None else jnp.asarray(st))
        close(y, yj)
        close(ns, nsj)
    a, b = rec._rglru_coeffs(pt, cfg, t(u))
    aj, bj = jrec._rglru_coeffs(pj, jcfg, jnp.asarray(u))
    close(a, aj)
    close(b, bj)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cache = {"h": rng.standard_normal((B, cfg.lru_width)).astype(np.float32),
             "conv": state}
    out, nc = rec.rglru_decode(pt, cfg, t(x),
                               {k: t(v) for k, v in cache.items()})
    outj, ncj = jrec.rglru_decode(pj, jcfg, jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, cache))
    close(out, outj)
    close(nc["h"], ncj["h"])
    close(nc["conv"], ncj["conv"])


@pytest.mark.parametrize("S", [12, 32])
def test_gqa_prefill_and_decode_match_jax(slice_, S):
    """S <= the window (16) and S a multiple of it: where the JAX package
    places the ring as the port does, caches and outputs agree."""
    cfg, jcfg = slice_["cfg"], slice_["jcfg"]
    pj = layer(slice_["jp"], "b2")["attn"]
    pt = port_layer(slice_["params"], "b2")["attn"]
    x = np.random.default_rng(S).standard_normal(
        (B, S + 3, cfg.d_model)).astype(np.float32)
    c = attn.gqa_cache_init(cfg, B, S_TOTAL, cfg.window, torch.float32,
                            torch.device("cpu"))
    cj = jattn.gqa_cache_init(jcfg, B, S_TOTAL, jcfg.window, jnp.float32)
    y, c = attn.gqa_prefill(pt, cfg, t(x[:, :S]), c, cfg.window)
    yj, cj = jax.jit(jattn.gqa_prefill, static_argnums=(1, 4))(
        pj, jcfg, jnp.asarray(x[:, :S]), cj, jcfg.window)
    close(y, yj)
    close(c["k"], cj["k"])
    close(c["v"], cj["v"])
    for pos in range(S, S + 3):
        y, c = attn.gqa_decode(pt, cfg, t(x[:, pos:pos + 1]), c, pos,
                               cfg.window)
        yj, cj = jax_gqa_decode(pj, jcfg, jnp.asarray(x[:, pos:pos + 1]),
                                cj, jnp.asarray(pos, jnp.int32), jcfg.window)
        close(y, yj)
        close(c["k"], cj["k"])


def test_gqa_prefill_places_the_ring_by_position(slice_):
    """A 20-token prompt at window 16: the key at position p sits in slot
    p mod 16."""
    cfg, jcfg = slice_["cfg"], slice_["jcfg"]
    pj = layer(slice_["jp"], "b2")["attn"]
    pt = port_layer(slice_["params"], "b2")["attn"]
    S = 20
    x = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    c = attn.gqa_cache_init(cfg, B, S_TOTAL, cfg.window, torch.float32,
                            torch.device("cpu"))
    _, c = attn.gqa_prefill(pt, cfg, t(x), c, cfg.window)
    _, k, _ = jattn._project_qkv(pj, jcfg, jnp.asarray(x),
                                 jnp.arange(S)[None, :])
    k = np.asarray(k)
    for p in range(S - cfg.window, S):
        close(c["k"][:, p % cfg.window], k[:, p])


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [12, 32])
def test_prefill_and_decode_logits_match_jax(slice_, n):
    """Prompts of 12 (<= the window of 16) and 32 (twice the window)
    tokens, then decode steps teacher-forced to the end of the run."""
    m, params, toks = slice_["m"], slice_["params"], slice_["toks"]
    jp = slice_["jp"]
    cache = m.init_cache(B, S_TOTAL, "cpu")
    logits, cache = m.prefill(params, {"tokens": t(toks[:, :n])}, cache)
    jc = slice_["jm"].init_cache(B, S_TOTAL)
    jl, jc = slice_["jprefill"](jp, {"tokens": jnp.asarray(toks[:, :n])},
                                jc)
    assert logits.shape == (B, 1, slice_["cfg"].vocab_size)
    close(logits, jl, LOGIT_TOL)
    for step in range(n, S_TOTAL - 1):
        tok = toks[:, step:step + 1]
        logits, cache = m.decode_step(params, cache, t(tok))
        jl, jc = slice_["jdecode"](jp, jc, jnp.asarray(tok))
        close(logits, jl, LOGIT_TOL)
        close(logits[:, 0], slice_["forward"][:, step], LOGIT_TOL)


def test_decode_past_an_unaligned_window_matches_jax_forward(slice_):
    """A 20-token prompt at window 16 (longer than the window, not a
    multiple of it): every decode step's logits agree with the JAX
    package's teacher-forced forward pass.  (The JAX package's own decode
    misplaces the ring here and is off by about 0.4-1.7.)"""
    m, params, toks = slice_["m"], slice_["params"], slice_["toks"]
    n = 20
    cache = m.init_cache(B, S_TOTAL, "cpu")
    logits, cache = m.prefill(params, {"tokens": t(toks[:, :n])}, cache)
    close(logits[:, 0], slice_["forward"][:, n - 1], LOGIT_TOL)
    for step in range(n, S_TOTAL - 1):
        logits, cache = m.decode_step(params, cache,
                                      t(toks[:, step:step + 1]))
        close(logits[:, 0], slice_["forward"][:, step], LOGIT_TOL)


def test_greedy_tokens_equal_jax(slice_):
    m, params, toks = slice_["m"], slice_["params"], slice_["toks"]
    n, steps = 16, 8
    ours, _ = greedy_generate(m, params, {"tokens": t(toks[:, :n])},
                              m.init_cache(B, n + steps, "cpu"), steps)
    want, _ = jax_greedy_generate(slice_["jm"], slice_["jp"],
                                  {"tokens": jnp.asarray(toks[:, :n])},
                                  slice_["jm"].init_cache(B, n + steps),
                                  steps)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


def test_converter_refuses_a_tree_that_does_not_fit(slice_):
    cfg = slice_["cfg"]
    tree = slice_["drawn"]
    b0 = {k: v for k, v in tree["body"]["b0"].items() if k != "mlp"}
    missing = dict(tree, body=dict(tree["body"], b0=b0))
    with pytest.raises(ValueError, match=r"missing leaves \['mlp'\]"):
        params_from_jax(missing, cfg, "cpu")
    extra = dict(tree, vis_proj=tree["lm_head"])
    with pytest.raises(ValueError, match=r"extra leaves \['vis_proj'\]"):
        params_from_jax(extra, cfg, "cpu")
    wrong = dict(tree, final_norm=np.zeros(cfg.d_model + 1, np.float32))
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(wrong, cfg, "cpu")


def zoo_batch(cfg, B=2, S=12, seed=0):
    """A numpy training batch for ``cfg``'s family: tokens and labels,
    and an enc-dec config's frame embeddings or a vision config's image
    embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frame_embeds"] = rng.standard_normal(
            (B, 10, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", list_configs())
def test_every_config_inits_trains_and_serves(arch):
    """Every architecture at its smoke config on the CPU: init, a finite
    loss with a finite gradient for every leaf (none all zero), and a
    prefill and three decode steps with finite logits.  (Until this
    slice MLA, xLSTM, the vision frontend and the encoder-decoder raised
    ``NotImplementedError``.)"""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import loop
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="float32")
    m = build_model(cfg)
    params = m.init(0, "cpu")
    batch = zoo_batch(cfg)
    loss, grads = loop.make_grad_step(m)(params, batch)
    assert np.isfinite(float(loss))
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
        assert bool(g.ne(0).any())
    prompt = {k: t(v) for k, v in batch.items() if k != "labels"}
    B, S = batch["tokens"].shape
    cache = m.init_cache(B, S + 4 + cfg.n_frontend_tokens, "cpu")
    logits, cache = m.prefill(params, prompt, cache)
    for _ in range(3):
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        logits, cache = m.decode_step(params, cache,
                                      logits[:, -1].argmax(-1, keepdim=True))
    assert bool(torch.isfinite(logits).all())
