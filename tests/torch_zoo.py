"""Shared pieces of the model-zoo tests (``tests/test_torch_mla.py``,
``test_torch_xlstm.py``, ``test_torch_encdec.py``, ``test_torch_vlm.py``):
one architecture's smoke config in float32 built by both packages on
the same weights, and the whole-model checks against the JAX package.

The weights are drawn once by the port's init on the CPU, handed to the
JAX model as numpy arrays (their layout checked against
``jax.eval_shape`` of its init) and carried back onto the port with
``params_from_jax``, as ``tests/test_torch_serve.py``'s fixture does.

Tolerances, as ``tests/test_torch_serve.py`` and ``test_torch_train.py``
hold the earlier slices: modules at rtol and atol 1e-5 (float32 in
another order), the loss at 1e-5, every gradient leaf at 1e-4, prefill
and decode logits at 1e-4, greedy tokens equal.
"""
import dataclasses
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.train.serve import greedy_generate as jax_greedy_generate
from repro.train.serve import make_decode_step, make_prefill_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import loop
from repro_torch.train.serve import greedy_generate

MOD_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
HARD_LIMIT_S = 180.0


@pytest.fixture(autouse=True)
def hard_limit():
    """Fail the test after ``HARD_LIMIT_S`` seconds (a hang raises)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {HARD_LIMIT_S} s hard limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, HARD_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def pair(arch: str, **overrides) -> dict:
    """Both packages' models of ``arch``'s float32 smoke config (with
    ``overrides``) on the same weights."""
    def cfg_of(get, smoke):
        return dataclasses.replace(smoke(get(arch)), dtype="float32",
                                   **overrides)

    jcfg = cfg_of(jax_get_config, jax_smoke_config)
    cfg = cfg_of(get_config, smoke_config)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), m.init(0, "cpu"))
    layout = jax.eval_shape(jm.init, jax.random.key(0))
    assert jax.tree.structure(drawn) == jax.tree.structure(layout)
    assert jax.tree.map(np.shape, drawn) == jax.tree.map(
        lambda s: s.shape, layout)
    assert jax.tree.map(lambda x: x.dtype, drawn) == jax.tree.map(
        lambda s: s.dtype, layout)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, drawn=drawn,
                jp=jax.tree.map(jnp.asarray, drawn),
                params=params_from_jax(drawn, cfg, "cpu"))


def t(x):
    return torch.from_numpy(np.array(x))


def close(ours, want, tol=MOD_TOL, msg=""):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=msg)


def close_tree(ours, want, tol=MOD_TOL):
    """Every leaf of a dict tree of tensors against a JAX tree."""
    got, exp = flat(ours), flat(want)
    assert sorted(got) == sorted(exp)
    for path in exp:
        np.testing.assert_allclose(got[path], exp[path], rtol=tol,
                                   atol=tol, err_msg=path)


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


def jax_batch(batch: dict) -> dict:
    """A numpy batch for the JAX package: integer arrays as int32."""
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def check_loss_and_grads(p: dict, batch: dict, remat: bool = False):
    """The loss at ``LOSS_TOL`` and every gradient leaf at ``GRAD_TOL``
    of one numpy ``batch`` against ``jax.value_and_grad``."""
    jm = p["jm"]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q, b: jm.loss(q, b, mode="scan", remat=remat)[0]))(
            p["jp"], jax_batch(batch))
    params = params_from_jax(p["drawn"], p["cfg"], "cpu")
    loss, grads = loop.make_grad_step(p["m"], remat=remat)(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    want, got = flat(jgrads), flat(grads)
    assert sorted(want) == sorted(got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=path)
    return float(loss)


def check_serving(p: dict, prompt: dict, follow: np.ndarray, s_max: int,
                  steps: int):
    """Prefill of the numpy ``prompt`` batch, then a decode step for each
    column of ``follow`` (B, n) teacher-forced: logits against the JAX
    package's at ``LOGIT_TOL``; then ``steps`` greedy tokens equal."""
    m, jm, params, jp = p["m"], p["jm"], p["params"], p["jp"]
    jprefill = jax.jit(make_prefill_step(jm))
    jdecode = jax.jit(make_decode_step(jm))
    tb = {k: t(v) for k, v in prompt.items()}
    jb = jax_batch(prompt)
    B = follow.shape[0]
    logits, cache = m.prefill(params, tb, m.init_cache(B, s_max, "cpu"))
    jl, jc = jprefill(jp, jb, jm.init_cache(B, s_max))
    assert logits.shape == (B, 1, p["cfg"].vocab_size)
    close(logits, jl, LOGIT_TOL, "prefill")
    for j in range(follow.shape[1]):
        tok = follow[:, j:j + 1]
        logits, cache = m.decode_step(params, cache, t(tok))
        jl, jc = jdecode(jp, jc, jnp.asarray(tok, jnp.int32))
        close(logits, jl, LOGIT_TOL, f"decode step {j}")
    ours, _ = greedy_generate(m, params, tb, m.init_cache(B, s_max, "cpu"),
                              steps)
    want, _ = jax_greedy_generate(jm, jp, jb, jm.init_cache(B, s_max), steps)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
