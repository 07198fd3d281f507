"""The port's experiment layer (``repro_torch.experiments``: spec, plan,
engine, store and CLI) held against the JAX package's and against the
results store it wrote, on the CPU.

* **The store as oracle.**  Every committed ``results/store`` entry's
  spec, read by the port, hashes to its file name, the live entry's
  too.  Each stored batch Monte-Carlo entry (fig5,
  fig6, fig7, their ``-quick`` cuts and the ``mc`` demo-live; all on the
  ``numpy`` backend) is rerun through ``run_experiment(...,
  device="cpu")`` and every report field must equal the stored one
  **bit for bit** (``==`` on the parsed JSON); a second run into a
  fresh store is a cache hit with the same reports.
* **The ``cuda`` backend** (its plain PyTorch version on the CPU) runs a
  small spec, per scheme and fused: its reports are those of
  ``mc_grid`` / ``mc_grid_panel`` called directly with the task seeds,
  and those calls are held row by row against the reference's
  ``pallas`` backend as ``tests/test_torch_schemes.py`` holds them
  (>= 99% of rows with equal iterations, ``t_comp`` rtol 1e-4 on them,
  means at 6 SE); host-drawn schemes are equal bit for bit.
* **The demos**: the ``drifting`` and ``trace`` demo specs hash as the
  reference's and, on ``numpy``, give its reports bit for bit.
* **The stored training entries** (``fig-train-*``): the port's run on
  the CPU against a fresh run of the reference on the same spec, the
  JAX side training from the port's weights (patched in, as
  ``tests/test_torch_hettrain_runner.py`` does), each side's trajectory
  computed once: every field but the losses equal, the losses at 1e-4.
  Against the stored entry, written by the reference on another host,
  the scheduling fields are equal but for ``STORE_ULP_FIELDS``, each
  within ``STORE_ULPS`` ulps: the reference rerun here gives the port's
  bits, so the gap is the writing host's, not the port's.  The stored
  losses come from the JAX package's own weights, so the fields that
  follow the loss are not held to the store.
* ``HetTrainer(trace_corpus=...)`` gives the reference's scheduling
  fields exactly (the weights carried over as in
  ``tests/test_torch_hetsched.py``; the loss at 1e-4).
* The CLI's ``main`` runs ``--demo quick --check-cache`` and ``--demo
  live-fault --check-cache`` on the CPU, and ``ls`` lists every stored
  entry.  (The serving entries and demos are
  ``tests/test_torch_serving.py``'s; the live control plane is
  ``tests/test_torch_control.py``'s.)
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as ref_core
import repro.experiments as ref_exp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import UnitStore as JaxUnitStore
from repro.distributed.hetsched import HetTrainer as JaxHetTrainer
from repro.hettrain import config as jax_config
from repro.hettrain import runner as jax_runner
from repro.experiments import __main__ as ref_cli
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import get_scheme, mc_grid_panel
from repro_torch.data import UnitStore
from repro_torch.distributed import HetTrainer
from repro_torch.experiments import (ExperimentResult, ExperimentSpec,
                                     ResultsStore, ScenarioGrid,
                                     compile_plan, run_experiment,
                                     scheme_spec)
from repro_torch.experiments import __main__ as cli
from repro_torch.hettrain import MODEL_PRESETS, TrainConfig, run_training_grid
from repro_torch.hettrain import runner as torch_runner
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW

from test_torch_cuda import assert_rows_agree

ROOT = Path(__file__).resolve().parents[1]
STORE = ROOT / "results" / "store"
ENTRIES = sorted(STORE.glob("*.json"))


def entry(path):
    return json.loads(path.read_text())


def live_axis(spec_dict):
    return ("live" in spec_dict
            or spec_dict.get("execution", "mc") != "mc")


MC_ENTRIES = [p for p in ENTRIES
              if not live_axis(entry(p)["spec"])
              and "training" not in entry(p)["spec"]
              and "serving" not in entry(p)["spec"]]


def test_the_store_holds_the_entries_this_file_reads():
    names = sorted(entry(p)["spec"]["name"] for p in MC_ENTRIES)
    assert names == ["demo-live", "fig5", "fig5-quick", "fig6", "fig6-quick",
                     "fig7", "fig7-quick"]
    assert len(ENTRIES) == 15


@pytest.mark.parametrize("path", ENTRIES, ids=lambda p: p.stem[:12])
def test_stored_spec_hashes_to_its_address(path):
    spec = entry(path)["spec"]
    ours = ExperimentSpec.from_dict(spec)
    assert ours.spec_hash() == path.stem
    assert ours.to_dict() == spec
    assert compile_plan(ours).spec_hash == path.stem
    # the store reads the reference's record back whole
    got = ResultsStore(STORE).get(ours)
    assert got is not None and got.spec_hash == path.stem
    assert got.to_dict()["reports"] == entry(path)["reports"]


@pytest.mark.parametrize("path", MC_ENTRIES,
                         ids=lambda p: entry(p)["spec"]["name"])
def test_stored_entry_is_reproduced_bit_for_bit(path, tmp_path):
    stored = entry(path)
    spec = ExperimentSpec.from_dict(stored["spec"])
    store = ResultsStore(tmp_path)
    result = run_experiment(spec, store=store, device="cpu")
    assert not result.cache_hit
    assert result.spec_hash == path.stem
    assert result.to_dict()["reports"] == stored["reports"]
    assert result.env["device"] == "cpu" and "torch" in result.env
    again = run_experiment(spec, store=store, device="cpu")
    assert again.cache_hit
    assert again.to_dict()["reports"] == stored["reports"]
    assert store.entries() == [path.stem]


K, N, TRIALS = 12, 30_000, 64
POINTS = [(10.0, 10.0 ** 2 / 6, 10), (40.0, 40.0 ** 2 / 6, 40)]
SCHEMES = ("fixed", "mds", "work_exchange", "work_exchange_unknown",
           "het_mds", "hedged")


def small_spec(backend, panel="per_scheme"):
    return ExperimentSpec(
        name="small", grid=ScenarioGrid(K=K, points=POINTS),
        schemes=tuple(scheme_spec(s) for s in SCHEMES), N=N, trials=TRIALS,
        seed=77, backend=backend, panel=panel)


def rows_of(report):
    return (report.t_comp_trials, report.iterations_trials,
            report.n_comm_trials)


@pytest.mark.parametrize("panel", ["per_scheme", "fused"])
def test_cuda_backend_through_the_layer(panel):
    result = run_experiment(small_spec("cuda", panel), device="cpu")
    ref = ref_exp.run_experiment(small_spec_ref("pallas", panel))
    assert result.spec_hash == small_spec("cuda", panel).replace(
        backend="cuda", devices=1).spec_hash()
    specs = compile_plan(small_spec("cuda")).het_specs
    ref_specs = ref_exp.compile_plan(small_spec_ref("pallas")).het_specs
    schemes = {s: get_scheme(s) for s in SCHEMES}
    direct = mc_grid_panel(schemes, specs, N, TRIALS,
                           {s: np.random.default_rng(77) for s in SCHEMES},
                           keep_trials=True, backend="cuda", device="cpu") \
        if panel == "fused" else {
            s: schemes[s].mc_grid(specs, N, TRIALS,
                                  np.random.default_rng(77),
                                  keep_trials=True, backend="cuda",
                                  device="cpu") for s in SCHEMES}
    ref_schemes = {s: ref_core.get_scheme(s) for s in SCHEMES}
    ref_direct = ref_core.schemes.mc_grid_panel(
        ref_schemes, ref_specs, N, TRIALS,
        {s: np.random.default_rng(77) for s in SCHEMES}, keep_trials=True,
        backend="pallas") if panel == "fused" else {
            s: ref_schemes[s].mc_grid(ref_specs, N, TRIALS,
                                      np.random.default_rng(77),
                                      keep_trials=True, backend="pallas")
            for s in SCHEMES}
    for s in SCHEMES:
        rows = result.report(s)
        assert [r.to_dict() for r in rows] == \
            [r.to_dict(include_trials=False) for r in direct[s]]
        for a, b, ra in zip(direct[s], ref_direct[s], ref.report(s)):
            if s in ("work_exchange", "work_exchange_unknown"):
                assert_rows_agree(rows_of(a), rows_of(b))
            elif s == "mds":
                assert a.extra["L"] == b.extra["L"]
                assert a.t_comp == pytest.approx(b.t_comp, rel=1e-4)
            else:
                assert a.to_dict() == b.to_dict()
            # the reference's own experiment layer gave these rows too
            assert b.to_dict(include_trials=False) == ra.to_dict()
    fused = [r.extra.get("fused_panel") for r in result.report(
        "work_exchange")]
    assert fused == ([1, 1] if panel == "fused" else [None, None])


def small_spec_ref(backend, panel="per_scheme"):
    return ref_exp.ExperimentSpec.from_dict(
        {**small_spec(backend, panel).to_dict(), "backend": backend})


@pytest.mark.parametrize("demo", ["quick", "drifting", "trace", "train"])
def test_demo_specs_hash_as_the_reference(demo):
    assert cli.demo_spec(demo).to_dict() == ref_cli.demo_spec(demo).to_dict()
    assert cli.demo_spec(demo).spec_hash() == \
        ref_cli.demo_spec(demo).spec_hash()


@pytest.mark.parametrize("demo", ["drifting", "trace"])
def test_scenario_demos_on_numpy_are_the_reference(demo):
    ours = run_experiment(cli.demo_spec(demo).replace(backend="numpy"),
                          device="cpu")
    theirs = ref_exp.run_experiment(
        ref_cli.demo_spec(demo).replace(backend="numpy"))
    assert ours.spec_hash == theirs.spec_hash
    assert ours.to_dict()["reports"] == theirs.to_dict()["reports"]
    if demo == "drifting":
        assert all(r.extra.get("nominal_rates_only") == 1
                   for r in ours.report("hedged"))


def test_hcmm_demo_specs_are_the_reference():
    ours, theirs = cli.hcmm_demo_specs(), ref_cli.hcmm_demo_specs()
    assert [s.spec_hash() for s in ours] == [s.spec_hash() for s in theirs]


def test_training_spec_through_the_layer(tmp_path):
    """A training spec runs every task through ``run_training_grid`` on
    the given device: the layer's rows are the runner's."""
    spec = ExperimentSpec(
        name="t", grid=ScenarioGrid(K=4, points=[(4.0, 4.0 ** 2 / 6, 11)]),
        schemes=(scheme_spec("work_exchange"), scheme_spec("hedged")),
        N=8, trials=2, seed=3, backend="numpy",
        training=TrainConfig(model="tiny", steps=2))
    result = run_experiment(spec, store=ResultsStore(tmp_path), device="cpu")
    plan = compile_plan(spec)
    for task in plan.tasks:
        direct = run_training_grid(task.scheme, task.params_dict,
                                   plan.het_specs, spec.training, spec.N,
                                   spec.trials, task.seed, device="cpu")
        assert [r.to_dict() for r in result.report(task.key)] == \
            [r.to_dict() for r in direct]
    back = ExperimentResult.from_dict(json.loads(
        (tmp_path / f"{result.spec_hash}.json").read_text()))
    assert back.to_dict()["reports"] == result.to_dict()["reports"]
    assert spec.spec_hash() == ref_exp.ExperimentSpec.from_dict(
        spec.to_dict()).spec_hash()


TRAIN_ENTRIES = [p for p in ENTRIES if "training" in entry(p)["spec"]]
LOSS_FIELDS = ("loss_curve", "final_loss", "steps_to_target",
               "wall_to_target")
# means and deviations of host numpy sums, which the writing host summed
# in another order: the largest gap read on the CPU is 8 ulps (a
# deviation), the per-step means 1-2
STORE_ULP_FIELDS = ("t_comp_std", "t_comp_per_step")
STORE_ULPS = 8


def flat(tree, prefix=""):
    """{dotted path: leaf} of a report's nested dicts and lists."""
    if not isinstance(tree, (dict, list)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def losses_apart(reports):
    """(every field but the losses, the losses) of a spec's reports."""
    fields = flat(reports)
    lost = {p for p in fields if set(p.split(".")) & set(LOSS_FIELDS[:2])}
    return ({p: v for p, v in fields.items() if p not in lost},
            np.array([fields[p] for p in sorted(lost)]))


@pytest.fixture(scope="module")
def training_runs():
    """{entry path: (the port's reports, the reference's)} on the CPU."""
    training = TrainConfig.from_dict(entry(TRAIN_ENTRIES[0])["spec"][
        "training"])
    model, params = training.build_model("cpu")
    drawn = jax.tree.map(lambda x: x.numpy(), params)
    jm = jax_build_model(dataclasses.replace(
        jax_smoke_config(jax_get_config("phi3-mini-3.8b")), dtype="float32",
        vocab_size=training.vocab, **MODEL_PRESETS[training.model]))

    def once(compute):
        done = {}

        def trajectory(training, N, *args, **kw):
            key = (json.dumps(training.to_dict(), sort_keys=True), N)
            if key not in done:
                done[key] = compute(training, N, *args, **kw)
            return done[key]
        return trajectory

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_config.TrainConfig, "build_model",
                   lambda self: (jm, jax.tree.map(jnp.asarray, drawn)))
        mp.setattr(jax_runner, "compute_trajectory",
                   once(jax_runner.compute_trajectory))
        mp.setattr(torch_runner, "compute_trajectory",
                   once(torch_runner.compute_trajectory))
        for path in TRAIN_ENTRIES:
            d = entry(path)["spec"]
            ours = run_experiment(ExperimentSpec.from_dict(d), device="cpu")
            theirs = ref_exp.run_experiment(ref_exp.ExperimentSpec.from_dict(d))
            runs[path] = (ours.to_dict()["reports"],
                          theirs.to_dict()["reports"])
    return runs


@pytest.mark.parametrize("path", TRAIN_ENTRIES,
                         ids=lambda p: entry(p)["spec"]["name"])
def test_stored_training_entry_is_the_reference(training_runs, path):
    ours, theirs = training_runs[path]
    (fields, losses), (ref_fields, ref_losses) = map(losses_apart,
                                                     (ours, theirs))
    assert fields == ref_fields
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-4)
    stored = {p: v for p, v in flat(entry(path)["reports"]).items()
              if not set(p.split(".")) & set(LOSS_FIELDS)}
    held = {p: v for p, v in fields.items()
            if not set(p.split(".")) & set(LOSS_FIELDS)}
    assert held.keys() == stored.keys()
    off = {p for p in held if held[p] != stored[p]}
    assert all(set(p.split(".")) & set(STORE_ULP_FIELDS) for p in off), off
    assert all(abs(held[p] - stored[p]) <= STORE_ULPS
               * np.spacing(abs(stored[p])) for p in off)


def test_het_trainer_on_a_trace_corpus_is_the_reference():
    dims = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
                head_dim=16, n_kv_heads=2, d_ff=64, vocab_size=128)
    store = dict(unit_batch=2, seq_len=16, vocab=128, seed=3)
    rates = np.array([1.0, 4.0, 2.0, 8.0])
    cfg = dataclasses.replace(smoke_config(get_config("phi3-mini-3.8b")),
                              **dims)
    model = build_model(cfg)
    drawn = jax.tree.map(lambda x: x.numpy(), model.init(0, "cpu"))
    trainer = HetTrainer(model, AdamW(lr=1e-2, weight_decay=0.0), rates,
                         UnitStore(**store), units_per_step=16, seed=7,
                         trace_corpus="default_64x48")
    _, _, hist = trainer.train(params_from_jax(drawn, cfg, "cpu"), 2)
    jm = jax_build_model(dataclasses.replace(
        jax_smoke_config(jax_get_config("phi3-mini-3.8b")), **dims))
    jt = JaxHetTrainer(jm, JaxAdamW(lr=1e-2, weight_decay=0.0), rates,
                       JaxUnitStore(**store), units_per_step=16, seed=7,
                       trace_corpus="default_64x48")
    _, _, jhist = jt.train(jax.tree.map(jnp.asarray, drawn), 2)
    assert np.array_equal(trainer.pool.traces, jt.pool.traces)
    for a, b in zip(hist, jhist):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("loss") == pytest.approx(db.pop("loss"), rel=1e-4,
                                               abs=1e-4)
        assert da == db


def test_cli(tmp_path, capsys):
    store = str(tmp_path / "store")
    assert cli.main(["--demo", "quick", "--backend", "numpy", "--device",
                     "cpu", "--store", store, "--check-cache"]) == 0
    out = capsys.readouterr().out
    assert "check-cache: OK" in out and "backend=numpy" in out
    assert "computed in" in out and "cache HIT" not in out
    assert cli.main(["ls", "--store", store]) == 0
    assert "demo-quick" in capsys.readouterr().out
    live_store = str(tmp_path / "live")
    assert cli.main(["--demo", "live-fault", "--device", "cpu", "--store",
                     live_store, "--check-cache"]) == 0
    out = capsys.readouterr().out
    assert out.index("computed in") < out.index("check-cache: OK")
    assert "live[inproc]" in out and "lost=[0]" in out
    assert cli.main(["ls", "--store", str(STORE)]) == 0
    out = capsys.readouterr().out
    assert "not ported yet" not in out and "unreadable" not in out
    assert out.count("demo-live ") == 2 and "fig5-quick" in out
    assert cli.main(["compare", "825d75a6", "07eaead1", "--store",
                     str(STORE)]) == 0
    assert "combined SE" in capsys.readouterr().out
