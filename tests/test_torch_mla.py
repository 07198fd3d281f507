"""The port's MLA (multi-head latent attention, minicpm3-4b) held against
the JAX package at minicpm3's smoke config in float32, on shared weights
(``tests/torch_zoo.py``): ``mla_forward``, ``mla_prefill`` and
``mla_decode`` at rtol and atol 1e-5, the loss at 1e-5 and every
gradient leaf at 1e-4, prefill and decode logits at 1e-4 and greedy
tokens equal.  The port pads heads to a head dim of the flash kernel;
the padding is exact, and a head the kernel cannot take raises.  Each
check runs at the smoke config's heads (q.k 16, v 16: no padding) and at
heads the kernel takes only padded (q.k 20 and v 12, to 32), as
minicpm3's 96 and 64 are padded to 128 at full width.  GQA heads of a
dim the kernel lacks (phi3's 96, h2o-danube's 120) are padded the same
way: phi3's and h2o-danube's smoke configs at head dim 24 are held to
the JAX package likewise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo import (check_loss_and_grads, check_serving, close, hard_limit,
                       pair, t)

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.models import attention as attn
from repro_torch.models.transformer import _index

__all__ = ["hard_limit"]

ARCH = "minicpm3-4b"
B = 2


HEADS = {"smoke": {}, "padded": dict(qk_nope_dim=12, qk_rope_dim=8,
                                      v_head_dim=12)}


@pytest.fixture(scope="module", params=sorted(HEADS))
def mla(request):
    return pair(ARCH, **HEADS[request.param])


def layer(p, j=0):
    return (jax.tree.map(lambda x: x[j], p["jp"]["body"]["b0"])["attn"],
            _index(p["params"]["body"]["b0"], j)["attn"])


@pytest.mark.parametrize("S", [1, 12])
def test_mla_forward_matches_jax(mla, S):
    cfg, jcfg = mla["cfg"], mla["jcfg"]
    pj, pt = layer(mla)
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    close(attn.mla_forward(pt, cfg, t(x)),
          jattn.mla_forward(pj, jcfg, jnp.asarray(x)))


def test_mla_prefill_and_decode_match_jax(mla):
    cfg, jcfg = mla["cfg"], mla["jcfg"]
    pj, pt = layer(mla, 1)
    S, s_max = 10, 16
    x = np.random.default_rng(4).standard_normal(
        (B, S + 4, cfg.d_model)).astype(np.float32)
    c = attn.mla_cache_init(cfg, B, s_max, torch.float32,
                            torch.device("cpu"))
    cj = jattn.mla_cache_init(jcfg, B, s_max, jnp.float32)
    y, c = attn.mla_prefill(pt, cfg, t(x[:, :S]), c)
    yj, cj = jax.jit(jattn.mla_prefill, static_argnums=1)(
        pj, jcfg, jnp.asarray(x[:, :S]), cj)
    close(y, yj)
    close(c["latent"], cj["latent"])
    close(c["k_rope"], cj["k_rope"])
    jdecode = jax.jit(jattn.mla_decode, static_argnums=1)
    for pos in range(S, S + 4):
        y, c = attn.mla_decode(pt, cfg, t(x[:, pos:pos + 1]), c, pos)
        yj, cj = jdecode(pj, jcfg, jnp.asarray(x[:, pos:pos + 1]), cj,
                         jnp.asarray(pos, jnp.int32))
        close(y, yj)
        close(c["latent"], cj["latent"])
        close(c["k_rope"], cj["k_rope"])


def test_head_padding_is_exact_and_a_head_too_wide_raises():
    rng = np.random.default_rng(9)
    q, k = (t(rng.standard_normal((2, 7, 3, 24)).astype(np.float32))
            for _ in range(2))
    v = t(rng.standard_normal((2, 7, 3, 16)).astype(np.float32))
    scale = 24 ** -0.5
    got = attn.attention_ctx(q, k, v, scale)
    # the plain attention at the unpadded dims, v through its own dim
    scores = torch.einsum("bshd,bthd->bhst", q, k) * scale
    mask = torch.ones(7, 7, dtype=torch.bool).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    want = torch.einsum("bhst,bthd->bshd", probs, v)
    assert got.shape == (2, 7, 3, 16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    wide = t(rng.standard_normal((1, 4, 2, 260)).astype(np.float32))
    with pytest.raises(ValueError, match="q.k dim 260 and v dim 260"):
        attn.attention_ctx(wide, wide, wide, 1.0)
    # a padded q at the kernel's dim equals the plain op at that dim
    qp = torch.nn.functional.pad(q, (0, 8))
    kp = torch.nn.functional.pad(k, (0, 8))
    vp = torch.nn.functional.pad(v, (0, 16))
    torch.testing.assert_close(
        attention_ref(qp, kp, vp, True, 0, scale)[..., :16], want,
        rtol=1e-6, atol=1e-6)


def test_loss_and_every_gradient_leaf_match_jax(mla):
    cfg = mla["cfg"]
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, 24))
    loss = check_loss_and_grads(mla, {"tokens": toks[:, :-1],
                                      "labels": toks[:, 1:]})
    assert np.isfinite(loss)


def test_prefill_decode_logits_and_greedy_tokens_match_jax(mla):
    cfg = mla["cfg"]
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 20))
    check_serving(mla, {"tokens": toks[:, :14]}, toks[:, 14:], 24, 6)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "h2o-danube-3-4b"])
def test_gqa_heads_the_kernel_takes_only_padded_match_jax(arch):
    p = pair(arch, head_dim=24)
    toks = np.random.default_rng(13).integers(0, p["cfg"].vocab_size,
                                              (B, 21))
    assert np.isfinite(check_loss_and_grads(
        p, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}))
    check_serving(p, {"tokens": toks[:, :15]}, toks[:, 15:], 24, 6)
