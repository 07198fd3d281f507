"""The port's MoE serving slice held against the JAX package, on the CPU:
the batched expert product, the capacity-bounded dispatch, and
granite-moe-3b-a800m and qwen3-moe-30b-a3b end to end at their smoke
configs in float32.

Inputs are made with numpy from fixed seeds.  JAX runs on the CPU,
jitted, and its Pallas ``expert_matmul`` in interpret mode, as
``tests/test_kernels.py`` runs it; the port runs its plain versions, the
path a CPU tensor takes.  Both models run on the same weights: drawn by
the port's init, handed to JAX as numpy arrays, and carried back with
``params_from_jax``.

Tolerances: ``expert_matmul`` rtol and atol 1e-5 in float32 and 3e-2 in
bfloat16, as ``tests/test_kernels.py`` holds the Pallas kernel (float32
sums in another order; bf16 output keeps 8 significand bits).  The MoE
layer 1e-5 (float32 in another order; the routing and the slot ranks are
equal, so the same pairs are dropped).  Whole-model logits 1e-4, as
``tests/test_torch_serve.py`` holds the dense slice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.moe_gmm.kernel import expert_matmul as jax_expert_matmul
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.train.serve import greedy_generate as jax_greedy_generate
from repro.train.serve import make_decode_step, make_prefill_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.moe_gmm import (expert_matmul, expert_matmul_cuda,
                                         expert_matmul_ref)
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.train.serve import greedy_generate

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
MOD_TOL = 1e-5
LOGIT_TOL = 1e-4
GMM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, S_TOTAL, N_PROMPT = 2, 20, 12


def f32_smoke(get, smoke, arch):
    return dataclasses.replace(smoke(get(arch)), dtype="float32")


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(ours, want, tol=MOD_TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def build_slice(arch):
    """Both models of ``arch`` on the same weights (see the module
    docstring), and a (B, 20) token run."""
    jcfg = f32_smoke(jax_get_config, jax_smoke_config, arch)
    cfg = f32_smoke(get_config, smoke_config, arch)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), m.init(0, "cpu"))
    layout = jax.eval_shape(jm.init, jax.random.key(0))
    assert jax.tree.structure(drawn) == jax.tree.structure(layout)
    assert jax.tree.map(np.shape, drawn) == jax.tree.map(
        lambda s: s.shape, layout)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, S_TOTAL))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, drawn=drawn, toks=toks,
                jp=jax.tree.map(jnp.asarray, drawn),
                params=params_from_jax(drawn, cfg, "cpu"),
                jprefill=jax.jit(make_prefill_step(jm)),
                jdecode=jax.jit(make_decode_step(jm)))


@pytest.fixture(scope="module")
def slices():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = build_slice(arch)
        return built[arch]
    return get


def mlp_params(sl, j=0):
    """Layer j's MoE weights, as JAX arrays and as the port's tensors."""
    pj = jax.tree.map(lambda x: x[j], sl["jp"]["body"]["b0"]["mlp"])
    pt = transformer._index(sl["params"]["body"]["b0"]["mlp"], j)
    return pj, pt


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [
    (2, 32, 32, 32), (4, 64, 32, 64), (1, 128, 64, 32), (8, 32, 64, 64),
])
def test_expert_matmul_matches_pallas_kernel(dtype, E, C, D, F):
    rng = np.random.default_rng(E * C + D + F)
    buf = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    jbuf, jw = (jnp.asarray(a).astype(dtype) for a in (buf, w))
    want = jax_expert_matmul(jbuf, jw, block_c=32, block_f=32, block_d=32,
                             interpret=True)
    tdt = getattr(torch, dtype)
    got = expert_matmul(t(buf).to(tdt), t(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (E, C, F)
    close(got, np.asarray(want, np.float32), GMM_TOL[dtype])
    torch.testing.assert_close(got, expert_matmul_ref(t(buf).to(tdt),
                                                      t(w).to(tdt)),
                               rtol=0, atol=0)


def test_expert_matmul_cuda_refuses_a_cpu_tensor():
    x = torch.ones(2, 3, 4)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        expert_matmul_cuda(x, torch.ones(2, 4, 5))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_apply_matches_jax_scatter(slices, capacity_factor):
    """Drop-free at the smoke capacity factor (4.0), and at 0.5, where
    half the (token, k) pairs overflow: the slot ranks and the trash row
    agree exactly, so the same pairs are dropped."""
    sl = slices("granite-moe-3b-a800m")
    cfg, jcfg = sl["cfg"], sl["jcfg"]
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    pj, pt = mlp_params(sl)
    x = np.random.default_rng(3).standard_normal(
        (B, 16, cfg.d_model)).astype(np.float32)
    _, _, keep, C, _ = moe.route(pt, cfg, t(x))
    dropped = float((~keep).float().mean())
    assert (dropped == 0.0) == (capacity_factor is None), dropped
    out, aux = moe.moe_apply(pt, cfg, t(x))
    outj, auxj = jax.jit(jmoe.moe_apply_scatter, static_argnums=1)(
        pj, jcfg, jnp.asarray(x))
    close(out, outj)
    close(aux, auxj)


def test_moe_apply_matches_dense_references(slices):
    sl = slices("granite-moe-3b-a800m")
    cfg, jcfg = sl["cfg"], sl["jcfg"]
    pj, pt = mlp_params(sl, 1)
    x = np.random.default_rng(4).standard_normal(
        (B, 9, cfg.d_model)).astype(np.float32)
    out, _ = moe.moe_apply(pt, cfg, t(x))
    close(out, moe.moe_apply_dense_ref(pt, cfg, t(x)).numpy())
    close(out, jax.jit(jmoe.moe_apply_dense_ref, static_argnums=1)(
        pj, jcfg, jnp.asarray(x)))


def test_capacity_matches_jax():
    cfg = get_config("granite-moe-3b-a800m")
    jcfg = jax_get_config("granite-moe-3b-a800m")
    for n in (1, 4, 8000, 8123):
        assert moe._capacity(n, cfg) == jmoe._capacity(n, jcfg)
    assert moe._capacity(8000, cfg) == 2000


# ---------------------------------------------------------------------------
# the slice, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(slices, arch):
    """A 12-token prompt, then decode steps teacher-forced to the end of
    the run; qwen3-moe also runs the qk-norm."""
    sl = slices(arch)
    m, params, toks, jp = sl["m"], sl["params"], sl["toks"], sl["jp"]
    assert ("q_norm" in sl["drawn"]["body"]["b0"]["attn"]) == \
        arch.startswith("qwen3")
    cache = m.init_cache(B, S_TOTAL, "cpu")
    logits, cache = m.prefill(params,
                              {"tokens": t(toks[:, :N_PROMPT])}, cache)
    jc = sl["jm"].init_cache(B, S_TOTAL)
    jl, jc = sl["jprefill"](jp, {"tokens": jnp.asarray(toks[:, :N_PROMPT])},
                            jc)
    assert logits.shape == (B, 1, sl["cfg"].vocab_size)
    close(logits, jl, LOGIT_TOL)
    for step in range(N_PROMPT, S_TOTAL):
        tok = toks[:, step:step + 1]
        logits, cache = m.decode_step(params, cache, t(tok))
        jl, jc = sl["jdecode"](jp, jc, jnp.asarray(tok))
        close(logits, jl, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(slices, arch):
    sl = slices(arch)
    m, params, toks = sl["m"], sl["params"], sl["toks"]
    n, steps = 10, 6
    ours, _ = greedy_generate(m, params, {"tokens": t(toks[:, :n])},
                              m.init_cache(B, n + steps, "cpu"), steps)
    want, _ = jax_greedy_generate(sl["jm"], sl["jp"],
                                  {"tokens": jnp.asarray(toks[:, :n])},
                                  sl["jm"].init_cache(B, n + steps), steps)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


def test_converter_carries_an_moe_tree_and_keeps_the_router_fp32(slices):
    """The drawn float32 tree goes across leaf for leaf; converted for
    the bf16 config, the experts become bf16 and the router stays
    float32, as the JAX ``moe_init`` keeps it."""
    sl = slices("granite-moe-3b-a800m")
    back = jax.tree.map(lambda x: x.numpy(), sl["params"])
    assert jax.tree.structure(back) == jax.tree.structure(sl["drawn"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(sl["drawn"])):
        np.testing.assert_array_equal(a, b)
    bf16 = dataclasses.replace(sl["cfg"], dtype="bfloat16")
    conv = params_from_jax(sl["drawn"], bf16, "cpu")
    mlp = conv["body"]["b0"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert {mlp[k].dtype for k in ("wi_gate", "wi_up", "wo")} == \
        {torch.bfloat16}
    torch.testing.assert_close(mlp["router"],
                               t(sl["drawn"]["body"]["b0"]["mlp"]["router"]),
                               rtol=0, atol=0)
    assert build_model(bf16).init(0, "cpu")["body"]["b0"]["mlp"][
        "router"].dtype == torch.float32
