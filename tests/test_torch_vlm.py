"""The port's vision frontend (internvl2-26b: projected image embeddings in
front of the token embeddings) held against the JAX package at its smoke
config in float32, on shared weights (``tests/torch_zoo.py``): the
frontend's ``_embed_tokens`` at rtol and atol 1e-5, the loss on the text
positions at 1e-5 and every gradient leaf (``vis_proj`` included) at
1e-4, prefill and decode logits at 1e-4 and greedy tokens equal."""
import jax.numpy as jnp
import numpy as np
import pytest
from torch_zoo import (check_loss_and_grads, check_serving, close, hard_limit,
                       pair, t)

from repro.models import transformer as jtf
from repro_torch.models import transformer

__all__ = ["hard_limit"]

ARCH = "internvl2-26b"
B = 2


@pytest.fixture(scope="module")
def vlm():
    return pair(ARCH)


def images(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def test_embed_tokens_puts_the_projected_images_first(vlm):
    cfg, jcfg = vlm["cfg"], vlm["jcfg"]
    assert vlm["params"]["vis_proj"].shape == (cfg.d_model, cfg.d_model)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 6))
    img = images(cfg, 3)
    got = transformer._embed_tokens(vlm["params"], cfg,
                                    {"tokens": t(toks), "image_embeds":
                                     t(img)})
    want = jtf._embed_tokens(vlm["jp"], jcfg,
                             {"tokens": jnp.asarray(toks),
                              "image_embeds": jnp.asarray(img)})
    assert got.shape == (B, cfg.n_frontend_tokens + 6, cfg.d_model)
    close(got, want)
    # without images the frontend adds nothing
    close(transformer._embed_tokens(vlm["params"], cfg, {"tokens": t(toks)}),
          want[:, cfg.n_frontend_tokens:])


def test_loss_on_text_positions_and_every_gradient_leaf_match_jax(vlm):
    cfg = vlm["cfg"]
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, 13))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "image_embeds": images(cfg, 12)}
    assert np.isfinite(check_loss_and_grads(vlm, batch))


def test_prefill_decode_logits_and_greedy_tokens_match_jax(vlm):
    cfg = vlm["cfg"]
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 14))
    prompt = {"tokens": toks[:, :9], "image_embeds": images(cfg, 13)}
    check_serving(vlm, prompt, toks[:, 9:], 9 + 8 + cfg.n_frontend_tokens,
                  6)


def test_serve_launcher_draws_the_reference_requests(vlm):
    """``launch.serve.prompt_batch``: the JAX launcher's tokens, then the
    image embeddings, from ``default_rng(0)``."""
    from repro_torch.launch.serve import prompt_batch
    cfg = vlm["cfg"]
    got = prompt_batch(cfg, 3, 10, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (3, 10))
    img = rng.normal(size=(3, cfg.n_frontend_tokens, cfg.d_model))
    assert sorted(got) == ["image_embeds", "tokens"]
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
    np.testing.assert_array_equal(got["image_embeds"].numpy(),
                                  img.astype(np.float32))
