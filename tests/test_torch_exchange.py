"""The port's master protocol (``core.exchange``, ``core.estimator``,
``core.runtime``, ``core.coded``, ``Scheme.make_scheduler``) held
against the JAX package's, on the CPU.

The protocol is host numpy in both packages, copied line for line, so
every scheduler, estimator and worker pool below is driven epoch by epoch
from the same seeds and held **exactly**: queues, wait modes, iteration
logs, ``t_comp``, ``n_comm``, estimated rates, finish times, credited
groups.  ``HetTrainRuntime`` runs real gradients of the ``tiny`` preset
(float32; weights drawn by the port and carried to JAX as numpy arrays)
and sums them in completion order: its scheduling fields are held
exactly, its loss and params at rtol and atol 1e-4, as
``tests/test_torch_hettrain.py`` holds the gradient engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import coded as ref_coded
from repro.core import estimator as ref_est
from repro.core import exchange as ref_exchange
from repro.core import runtime as ref_runtime
from repro.core.schemes import get_scheme as ref_get_scheme
from repro.data import UnitStore as JaxUnitStore
from repro.hettrain.policies import policy_mode as ref_policy_mode
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro_torch.core import coded, estimator, exchange, runtime
from repro_torch.core.schemes import get_scheme
from repro_torch.data import UnitStore
from repro_torch.hettrain import MODEL_PRESETS, TrainConfig, policy_mode
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.train.loop import make_grad_step

RATES = np.array([1.0, 4.0, 2.0, 8.0, 3.0])
PACKAGES = {"port": (exchange, estimator, runtime),
            "ref": (ref_exchange, ref_est, ref_runtime)}


def drive(pkg, make_sched, seed=11, fail_at=None, revive_at=None,
          epochs=40):
    """Run a master over its package's pool to completion; return every
    epoch's observable state."""
    ex, _, rt = PACKAGES[pkg]
    sched = make_sched(ex)
    pool = rt.VirtualWorkerPool(RATES, seed=seed)
    dead = np.zeros(RATES.size, dtype=bool)
    seen = []
    for epoch in range(epochs):
        if epoch == fail_at:
            dead[2] = True
            sched.mark_failed(2)
        if epoch == revive_at:
            dead[2] = False
            sched.revive(2)
        a = sched.next_assignment()
        if a is None:
            break
        elapsed, done = pool.run_epoch(a, dead)
        sched.report(done, elapsed)
        log = sched.logs[-1]
        seen.append((a.queues, a.wait_all, a.sizes.tolist(), elapsed,
                     done.tolist(), log.assignment_sizes.tolist(),
                     log.done_counts.tolist(), log.elapsed,
                     log.moved_units, sched.n_comm, sched.t_comp,
                     sched.iterations, sched.estimated_rates().tolist(),
                     pool.last_t_k.tolist(), sorted(sched.done_ids)))
    assert sched.finished
    return seen


MASTERS = {
    "known": lambda ex, est: ex.MasterScheduler(range(300), 5, rates=RATES,
                                                threshold_frac=0.05),
    "unknown": lambda ex, est: ex.MasterScheduler(range(300), 5),
    "unknown capped": lambda ex, est: ex.MasterScheduler(
        range(300), 5, threshold_frac=0.02, storage_cap_frac=0.5),
    "unknown ema": lambda ex, est: ex.MasterScheduler(
        range(300), 5, estimator=est.make_estimator("ema", 5)),
    "unknown bayes": lambda ex, est: ex.MasterScheduler(
        range(300), 5, estimator=est.make_estimator("bayes", 5,
                                                    quantile=0.2)),
}


@pytest.mark.parametrize("case", sorted(MASTERS))
@pytest.mark.parametrize("fault", ["", "fail", "fail+revive"])
def test_master_scheduler_is_the_reference_epoch_by_epoch(case, fault):
    fail_at = {"": None, "fail": 1, "fail+revive": 1}[fault]
    revive_at = 3 if fault == "fail+revive" else None
    runs = [drive(pkg, lambda ex, p=pkg: MASTERS[case](ex, PACKAGES[p][1]),
                  fail_at=fail_at, revive_at=revive_at)
            for pkg in ("port", "ref")]
    assert len(runs[0]) >= 2
    assert runs[0] == runs[1]


def test_cover_scheduler_is_the_reference():
    outs = []
    for ex, _, rt in (PACKAGES["port"], PACKAGES["ref"]):
        sched = ex.CoverScheduler(range(100, 150), 5, s=1)
        a = sched.next_assignment()
        pool = rt.VirtualWorkerPool(RATES, seed=3)
        dead = np.array([False, True, False, False, False])
        t_k = pool.finish_times(a.sizes, dead)
        sched.mark_failed(1)
        t_done, done, groups = sched.resolve(t_k)
        outs.append((a.queues, a.wait_all, sched.next_assignment(),
                     t_k.tolist(), t_done, done.tolist(), groups,
                     sched.n_comm, sched.iterations, sched.t_comp,
                     sched.finished))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="workers"):
        exchange.CoverScheduler(range(10), 1, s=1)
    lost = exchange.CoverScheduler(range(10), 4, s=1)
    lost.next_assignment()
    with pytest.raises(RuntimeError, match="coverage impossible"):
        lost.resolve(np.array([np.inf, 1.0, np.inf, 2.0]))


@pytest.mark.parametrize("kind,kw", [
    ("cumulative", {}), ("ema", {"alpha": 0.3}), ("bayes", {}),
    ("bayes", {"quantile": 0.01}), ("bayes", {"quantile": 0.3}),
    ("bayes", {"quantile": 0.99})])
def test_estimators_are_the_reference(kind, kw):
    rng = np.random.default_rng(5)
    ours = estimator.make_estimator(kind, 6, 2.0, **kw)
    theirs = ref_est.make_estimator(kind, 6, 2.0, **kw)
    assert type(ours).__name__ == type(theirs).__name__
    assert np.array_equal(ours.rates(), theirs.rates())
    for _ in range(5):
        done = rng.integers(0, 9, size=6) * (rng.random(6) < 0.7)
        elapsed = float(rng.exponential())
        ours.update(done, elapsed)
        theirs.update(done, elapsed)
        assert np.array_equal(ours.rates(), theirs.rates())
    ours.update(np.ones(6), 0.0)            # a zero-time epoch
    theirs.update(np.ones(6), 0.0)
    assert np.array_equal(ours.rates(), theirs.rates())


def test_estimator_registry_and_norm_ppf():
    assert estimator.ESTIMATOR_REGISTRY.names() == \
        ref_est.ESTIMATOR_REGISTRY.names() == ["bayes", "cumulative", "ema"]
    for q in (1e-4, 0.02, 0.3, 0.5, 0.9, 0.99, 1 - 1e-4):
        assert estimator._norm_ppf(q) == ref_est._norm_ppf(q)
    with pytest.raises(ValueError):
        estimator._norm_ppf(1.0)
    with pytest.raises(KeyError, match="cumulative"):
        estimator.make_estimator("bogus", 3)


def test_virtual_worker_pool_is_the_reference():
    traces = np.abs(np.random.default_rng(1).normal(3.0, 1.0, (5, 3))) + 0.1
    for tr in (None, traces):
        outs = []
        for ex, _, rt in (PACKAGES["port"], PACKAGES["ref"]):
            pool = rt.VirtualWorkerPool(RATES, seed=2, unit_cost=1.5,
                                        traces=tr)
            seen = []
            for epoch in range(5):
                a = ex.Assignment(queues=[list(range(n)) for n in
                                          (3, 0, 7, 2, 9)],
                                  wait_all=epoch % 2 == 0)
                dead = np.array([False, False, epoch == 3, False, False])
                seen.append(pool.run_epoch(a, dead))
                seen.append(pool.finish_times([4, 1, 0, 6, 2]))
                seen.append(pool.rates_at(epoch).tolist())
            outs.append([(x[0], x[1].tolist()) if isinstance(x, tuple)
                         else np.asarray(x).tolist() for x in seen])
        assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="traces"):
        runtime.VirtualWorkerPool(RATES, traces=np.ones((4, 3)))
    with pytest.raises(ValueError, match="positive"):
        runtime.VirtualWorkerPool(RATES, traces=np.zeros((5, 3)))


PORTED = ("oracle", "fixed", "uniform", "mds", "work_exchange",
          "work_exchange_unknown", "gradient_coded")


@pytest.mark.parametrize("name", PORTED)
def test_make_scheduler_is_the_reference(name):
    assert policy_mode(get_scheme(name)) == ref_policy_mode(
        ref_get_scheme(name))
    if policy_mode(get_scheme(name)) == "simulate":
        with pytest.raises(NotImplementedError, match="master protocol"):
            get_scheme(name).make_scheduler([0], rates=RATES)
        return
    outs = []
    for get, (ex, est, rt) in ((get_scheme, PACKAGES["port"]),
                               (ref_get_scheme, PACKAGES["ref"])):
        sched = get(name).make_scheduler(
            list(range(40)), rates=RATES,
            estimator=est.make_estimator("cumulative", 5),
            threshold_frac=0.1)
        pool = rt.VirtualWorkerPool(RATES, seed=4)
        a = sched.next_assignment()
        if getattr(sched, "cover", False):
            out = sched.resolve(pool.finish_times(a.sizes))
        else:
            out = pool.run_epoch(a)
            sched.report(out[1], out[0])
        outs.append((type(sched).__name__, a.queues, a.wait_all,
                     repr(out), sched.n_comm, sched.iterations))
    assert outs[0] == outs[1]


def test_coded_baselines_are_the_reference():
    for K, s in ((6, 1), (6, 2), (8, 3)):
        ours, theirs = coded.GradientCoding(K, s), ref_coded.GradientCoding(
            K, s)
        assert ours.assignment(23) == theirs.assignment(23)
        assert ours.redundancy_factor() == theirs.redundancy_factor()
        rng = np.random.default_rng(K + s)
        grads = {u: rng.normal(size=4) for u in range(23)}
        replies = {w: {u: grads[u] for u in units}
                   for w, units in enumerate(ours.assignment(23))
                   if w >= s}                      # s stragglers lost
        assert np.array_equal(ours.decode(23, replies),
                              theirs.decode(23, replies))
    with pytest.raises(ValueError, match="divide|\\(s\\+1\\)"):
        coded.GradientCoding(5, 1)
    A = np.random.default_rng(0).normal(size=(11, 3))
    ours, theirs = coded.MDSCodedMatmul(5, 3), ref_coded.MDSCodedMatmul(5, 3)
    enc, ref_enc = ours.encode(A), theirs.encode(A)
    assert all(np.array_equal(a, b) for a, b in zip(enc, ref_enc))
    x = np.ones(3)
    replies = {k: enc[k] @ x for k in (4, 1, 3)}
    assert np.array_equal(ours.decode(replies), theirs.decode(replies))
    np.testing.assert_allclose(ours.decode(replies), A @ x, atol=1e-9)


# ---------------------------------------------------------------------------
# HetTrainRuntime over real gradients of the tiny preset
# ---------------------------------------------------------------------------

TRAIN = TrainConfig(model="tiny")
UNITS = list(range(12))
FAILURES = [(3, 1)]                              # worker 3 dies at epoch 1


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


@pytest.fixture(scope="module")
def runtimes():
    cfg = TRAIN.model_config()
    model, drawn = TRAIN.build_model("cpu")
    tree = jax.tree.map(lambda x: x.numpy(), drawn)
    jm = jax_build_model(dataclasses.replace(
        jax_smoke_config(jax_get_config("phi3-mini-3.8b")), dtype="float32",
        vocab_size=TRAIN.vocab, **MODEL_PRESETS[TRAIN.model]))
    store = dict(unit_batch=TRAIN.unit_batch, seq_len=TRAIN.seq_len,
                 vocab=TRAIN.vocab, seed=TRAIN.data_seed, structured=True)
    out = {}
    # the port
    grad_step = make_grad_step(model, remat=False)
    port_store = UnitStore(**store)
    opt = AdamW(lr=TRAIN.lr, weight_decay=TRAIN.weight_decay)
    rt = runtime.HetTrainRuntime(
        runtime.VirtualWorkerPool(RATES, seed=9),
        grad_fn=lambda p, u: grad_step(p, port_store.fetch(u)),
        update_fn=lambda p, s, g: opt.update(g, s, p),
        scheduler_factory=lambda ids: exchange.MasterScheduler(
            ids, 5, rates=RATES, threshold_frac=0.05),
        failures=[runtime.FailureEvent(w, i) for w, i in FAILURES])
    params = params_from_jax(tree, cfg, "cpu")
    state = opt.init(params)
    metrics = []
    for step in range(2):
        params, state, m = rt.step(params, state,
                                   [u + 12 * step for u in UNITS])
        metrics.append(m)
    out["port"] = (flat(params), metrics)
    # the JAX package
    jstore = JaxUnitStore(**store)
    jopt = JaxAdamW(lr=TRAIN.lr, weight_decay=TRAIN.weight_decay)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, mode="scan", remat=False)[0]))
    upd = jax.jit(jopt.update)
    jrt = ref_runtime.HetTrainRuntime(
        ref_runtime.VirtualWorkerPool(RATES, seed=9),
        grad_fn=lambda p, u: vg(p, jstore.fetch(u)),
        update_fn=lambda p, s, g: upd(g, s, p),
        scheduler_factory=lambda ids: ref_exchange.MasterScheduler(
            ids, 5, rates=RATES, threshold_frac=0.05),
        failures=[ref_runtime.FailureEvent(w, i) for w, i in FAILURES])
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    jmetrics = []
    for step in range(2):
        jp, jstate, m = jrt.step(jp, jstate, [u + 12 * step for u in UNITS])
        jmetrics.append(m)
    out["ref"] = (flat(jp), jmetrics)
    return out


def test_het_train_runtime_schedules_exactly_as_the_reference(runtimes):
    (_, ours), (_, theirs) = runtimes["port"], runtimes["ref"]
    for a, b in zip(ours, theirs):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("loss") == pytest.approx(db.pop("loss"), rel=1e-4,
                                               abs=1e-4)
        assert da == db
    assert [m.failed_workers for m in ours] == [[3], [3]]   # each step


def test_het_train_runtime_params_match_the_reference(runtimes):
    (ours, _), (theirs, _) = runtimes["port"], runtimes["ref"]
    assert sorted(ours) == sorted(theirs)
    for path in theirs:
        np.testing.assert_allclose(ours[path], theirs[path], rtol=1e-4,
                                   atol=1e-4, err_msg=path)
