"""The port's ``HetTrainer`` (``repro_torch.distributed.hetsched``) and
its compressors held against the JAX package's, on the CPU.

The setup is ``tests/test_hetsched.py``'s: phi3-mini's smoke config at
the ``tiny`` widths (2 layers, d_model 32, float32, vocab 128), units of
2 x 16 i.i.d. tokens, rates [1, 4, 2, 8], 16 units a step, pool seed 7,
AdamW at lr 1e-2 without weight decay, 2 steps.  The weights are drawn by
the port's init and carried to JAX as numpy arrays.  Every JAX run is
made once, in a module-scoped fixture.

Tolerances: the scheduling fields of each ``StepReport`` (``t_virtual``,
``iterations``, ``n_comm_units``, ``refetch_tokens``, ``grad_bytes``)
are host numpy in both packages and held **exactly**; the loss and the
params at rtol and atol 1e-4, as ``tests/test_torch_hettrain.py`` holds
the gradient engine.  Within the port the params after the last step are
**bitwise** equal across the five policies and with a failure (the
canonical gradient sum is policy-independent).  The int8 and top-k
round-trips are held against JAX's on one tree at rtol and atol 1e-6
(float32 elementwise work) and their wire bytes exactly.
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
from repro.distributed.compression import Int8Compressor as JaxInt8
from repro.distributed.compression import TopKCompressor as JaxTopK
from repro.distributed.hetsched import HetTrainer as JaxHetTrainer
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import UnitStore
from repro_torch.distributed import (POLICIES, HetTrainer, Int8Compressor,
                                     TopKCompressor)
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves, tree_map

RATES = np.array([1.0, 4.0, 2.0, 8.0])
DIMS = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2, head_dim=16,
            n_kv_heads=2, d_ff=64, vocab_size=128)
STORE = dict(unit_batch=2, seq_len=16, vocab=128, seed=3)
STEPS = 2
TRACES = np.array([[1.0, 0.5, 2.0], [4.0, 4.0, 1.0],
                   [2.0, 3.0, 2.0], [8.0, 1.0, 8.0]])
# run name -> (policy, HetTrainer kwargs, train kwargs)
RUNS = {**{p: (p, {}, {}) for p in POLICIES},
        "work_exchange failure": ("work_exchange", {},
                                  {"failures": {1: [3]}}),
        "work_exchange traces": ("work_exchange", {"traces": TRACES}, {})}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(smoke_config(get_config("phi3-mini-3.8b")),
                              **DIMS)
    jcfg = dataclasses.replace(
        jax_smoke_config(jax_get_config("phi3-mini-3.8b")), **DIMS)
    model = build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), model.init(0, "cpu"))
    return dict(cfg=cfg, model=model, drawn=drawn,
                jm=jax_build_model(jcfg))


def port_run(setup, name, compressor=None):
    policy, kw, train_kw = RUNS[name]
    trainer = HetTrainer(setup["model"], AdamW(lr=1e-2, weight_decay=0.0),
                         RATES, UnitStore(**STORE), policy=policy,
                         units_per_step=16, seed=7, compressor=compressor,
                         **kw)
    # train updates in place: every run starts from its own copy
    params = params_from_jax(setup["drawn"], setup["cfg"], "cpu")
    p, _, hist = trainer.train(params, STEPS, **train_kw)
    return p, hist


@pytest.fixture(scope="module")
def runs(setup):
    out = {}
    shared = None
    for name, (policy, kw, train_kw) in RUNS.items():
        jt = JaxHetTrainer(setup["jm"], JaxAdamW(lr=1e-2, weight_decay=0.0),
                           RATES, JaxUnitStore(**STORE), policy=policy,
                           units_per_step=16, seed=7, **kw)
        # every trainer has the same model, store and optimizer: let them
        # share the first one's jitted engine and update, so that JAX
        # compiles once (the functions and their inputs are unchanged)
        if shared is None:
            shared = (jt.engine, jt._update_fn)
        jt.engine, jt._update_fn = shared
        jp, _, jhist = jt.train(jax.tree.map(jnp.asarray, setup["drawn"]),
                                STEPS, **train_kw)
        out[name] = (port_run(setup, name), (flat(jp), jhist))
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_step_reports_match_the_reference(runs, name):
    (_, hist), (_, jhist) = runs[name]
    assert len(hist) == len(jhist) == STEPS
    for a, b in zip(hist, jhist):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("loss") == pytest.approx(db.pop("loss"), rel=1e-4,
                                               abs=1e-4)
        assert da == db
    if RUNS[name][0] == "gradient_coded":
        assert all(h.iterations == 1 for h in hist)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_params_match_the_reference(runs, name):
    (params, _), (jparams, _) = runs[name]
    got = flat(params)
    assert sorted(got) == sorted(jparams)
    for path, want in jparams.items():
        np.testing.assert_allclose(got[path], want, rtol=1e-4, atol=1e-4,
                                   err_msg=path)


def test_params_are_bitwise_across_policies_and_with_a_failure(runs):
    (first, hist0), _ = runs["equal_static"]
    for name in RUNS:
        (params, hist), _ = runs[name]
        for path, (a, b) in zip(flat(first), zip(tree_leaves(first),
                                                 tree_leaves(params))):
            assert torch.equal(a, b), (name, path)
        assert [h.loss for h in hist] == [h.loss for h in hist0]


def test_virtual_time_ordering(runs):
    """Paper Figure 5 on the integrated system, as tests/test_hetsched.py
    holds the JAX package: work exchange (known and online) and the
    heterogeneity-aware static split beat the equal split."""
    t = {name: np.mean([h.t_virtual for h in runs[name][0][1]])
         for name in ("equal_static", "het_static", "work_exchange",
                      "work_exchange_online")}
    assert t["work_exchange"] < t["equal_static"]
    assert t["work_exchange_online"] < t["equal_static"]
    assert t["het_static"] < t["equal_static"]


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressor_roundtrips_match_the_reference(kind):
    make = {"int8": (Int8Compressor, JaxInt8),
            "topk": (lambda: TopKCompressor(0.25),
                     lambda: JaxTopK(frac=0.25))}[kind]
    ours, theirs = make[0](), make[1]()
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(8, 16)), "b": {"c": rng.normal(size=33)},
            "z": rng.normal(size=(4, 5, 6)) * 1e-3}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    for worker in (0, 0, 1):       # the second call carries the residual
        got, nbytes = ours.roundtrip(
            tree_map(torch.from_numpy, jax.tree.map(np.copy, tree)), worker)
        want, jbytes = theirs.roundtrip(jax.tree.map(jnp.asarray, tree),
                                        worker)
        assert nbytes == jbytes
        want = flat(want)
        for path, g in flat(got).items():
            np.testing.assert_allclose(g, want[path], rtol=1e-6, atol=1e-6,
                                       err_msg=path)


def test_topk_error_feedback_recovers_mass(setup):
    """The second round ships the accumulated residual: at least the
    first round's mass (tests/test_hetsched.py's check)."""
    comp = TopKCompressor(frac=0.25)
    ones = tree_map(lambda x: torch.ones(x.shape),
                    params_from_jax(setup["drawn"], setup["cfg"], "cpu"))
    out1, _ = comp.roundtrip(ones, 0)
    out2, _ = comp.roundtrip(ones, 0)
    m1 = sum(float(x.sum()) for x in tree_leaves(out1))
    m2 = sum(float(x.sum()) for x in tree_leaves(out2))
    assert m2 >= m1


def test_int8_lossy_path_saves_bytes(setup, runs):
    (_, dense), _ = runs["work_exchange"]
    _, hist = port_run(setup, "work_exchange", compressor=Int8Compressor())
    assert hist[0].grad_bytes < 0.3 * dense[0].grad_bytes
    assert all(np.isfinite(h.loss) for h in hist)
    assert [h.t_virtual for h in hist] == [h.t_virtual for h in dense]


def test_bad_policy_and_trace_corpus_raise(setup):
    store = UnitStore(**STORE)
    with pytest.raises(ValueError, match="work_exchange_online"):
        HetTrainer(setup["model"], AdamW(), RATES, store, policy="bogus")
    with pytest.raises(FileNotFoundError, match="alibaba"):
        HetTrainer(setup["model"], AdamW(), RATES, store,
                   trace_corpus="alibaba")
    with pytest.raises(ValueError, match="not both"):
        HetTrainer(setup["model"], AdamW(), RATES, store, traces=TRACES,
                   trace_corpus="default_64x48")
