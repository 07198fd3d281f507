"""The ``torch`` serving engine (``repro_torch.serving.scan``) on the CPU:
a small-size port of the reference's ``TestBackendConformance``
(``tests/test_serving.py``), held against the port's numpy oracle, whose
bits are the reference's (``tests/test_torch_serving.py``).

Both engines build the same arrival streams (the numpy engine's first
draw) and draw service independently, so reports must close the same
ledger, admit exactly the same units, and agree within the Monte-Carlo
band on every latency / goodput / SLO metric -- the reference's bands,
at the reference's cell.  The engine's own exact properties: seed
determinism, the two-tier queue splice bitwise, bucketed against exact
shapes, censored parity.  What it refuses: closed-loop arrivals, an
adapter without a device form, and the default device without a card.
The card against the CPU is in ``tests/test_torch_cuda.py``.
"""
import sys

import numpy as np
import pytest
import torch

import repro_torch.serving.policies as policies
import repro_torch.serving.scan as scan
from repro_torch.core import HetSpec, list_schemes
from repro_torch.serving import (SERVING_ENV, ServingConfig,
                                 dispatch_policy, run_serving_grid)

RNG = np.random.default_rng
SCHEMES = list_schemes()

# the reference battery's cell
CELL_CFG = dict(loads=(0.7,), slots=600, deadline_slo=2.5)
CELL_N, CELL_TRIALS, CELL_SEED = 10, 8, 21


def small_het(K=6, mu=20.0, seed=3):
    return HetSpec.uniform_random(K, mu, mu * mu / 6.0, RNG(seed))


def grid(name, cfg, backend, het=None, N=CELL_N, trials=CELL_TRIALS,
         seed=CELL_SEED, **kw):
    return run_serving_grid(name, {}, [het or small_het()], cfg, N, trials,
                            seed, backend=backend, device="cpu", **kw)


@pytest.fixture(scope="module")
def cell():
    cfg = ServingConfig(**CELL_CFG)
    return {backend: {name: grid(name, cfg, backend)[0]
                      for name in SCHEMES}
            for backend in ("numpy", "torch")}


def closes_ledger(e):
    return e["units_admitted"] == pytest.approx(
        e["units_served"] + e["units_cancelled"] + e["units_backlog"])


@pytest.mark.parametrize("name", SCHEMES)
def test_torch_report_closes_ledger(cell, name):
    rep = cell["torch"][name]
    e = rep.extra
    assert e["serving_backend"] == "torch"
    assert rep.trials == CELL_TRIALS and np.isfinite(rep.t_comp)
    assert e["completed_jobs"] > 0
    assert e["p50"] <= e["p95"] + 1e-12 <= e["p99"] + 2e-12
    assert 0.0 <= e["reject_rate"] <= 1.0
    assert 0.0 <= e["slo_miss_rate"] <= 1.0
    assert closes_ledger(e)


@pytest.mark.parametrize("name", SCHEMES)
def test_engines_agree_within_band(cell, name):
    rn, rt = cell["numpy"][name], cell["torch"][name]
    # identical arrival streams: the offered demand matches exactly
    assert rn.extra["units_admitted"] == rt.extra["units_admitted"]
    assert set(rt.extra) - set(rn.extra) == {"serving_backend"}
    se = max(np.hypot(rn.t_comp_std, rt.t_comp_std)
             / np.sqrt(CELL_TRIALS), 1e-9)
    assert abs(rn.t_comp - rt.t_comp) <= 6 * se + 1e-12
    for q in ("p50", "p95", "p99"):
        assert abs(rn.extra[q] - rt.extra[q]) <= 6 * se + 1e-12, q
    g = rn.extra["goodput_units"]
    assert abs(g - rt.extra["goodput_units"]) <= max(
        6 * 0.03 * g, 6 * se * CELL_N) + 1e-12
    m = rn.extra["slo_miss_rate"]
    ntot = max(rn.extra["completed_jobs"] * CELL_TRIALS, 1.0)
    se_m = np.sqrt(max(m * (1 - m), 0.25 / ntot) / ntot)
    assert abs(m - rt.extra["slo_miss_rate"]) <= 6 * se_m + 1e-12


def test_every_registered_scheme_has_a_device_form():
    het = small_het()
    forms = {name: scan._policy_form(dispatch_policy(name, {}, het, 30))[0]
             for name in SCHEMES}
    assert set(forms.values()) == {"prop", "uniform", "mds", "cover",
                                   "hedged", "gc"}


def test_seed_determinism():
    cfg = ServingConfig(**CELL_CFG)
    a = grid("work_exchange", cfg, "torch")[0]
    b = grid("work_exchange", cfg, "torch")[0]
    assert a.to_dict() == b.to_dict()
    c = grid("work_exchange", cfg, "torch", seed=CELL_SEED + 1)[0]
    assert c.t_comp != a.t_comp


def test_env_resolution_reaches_the_engine(monkeypatch):
    monkeypatch.setenv(SERVING_ENV, "torch")
    rep = run_serving_grid("fixed", {}, [small_het()],
                           ServingConfig(**CELL_CFG), CELL_N, 2,
                           CELL_SEED, device="cpu")[0]
    assert rep.extra["serving_backend"] == "torch"


def test_queue_tier_splice_bitwise(monkeypatch):
    # fixed-units sweeps first run every row at the narrow _TIER_Q
    # physical queue width, then rerun exactly the rows whose true
    # admission cap was ever threatened at the full width; the splice
    # must be invisible -- bitwise equal to one full-width dispatch
    # slots 10x the auto width: the heavier load's queues outgrow the
    # narrow tier in some rows and not in others
    cfg = ServingConfig(loads=(0.95, 1.3), slots=300, slot_dt=0.04,
                        max_queue_jobs=48, deadline_slo=None)
    het = small_het(K=5, mu=25.0, seed=11)
    args = ("work_exchange", {}, [het], cfg, 20, 6, 77)
    rows = (het, "work_exchange", {}, cfg, 20, 6, 77, 0)
    out, meta = scan.sweep_rows(*rows, device="cpu")
    assert meta["passes"] == 2 and 0 < meta["rows_rerun"] < 12
    tiered = run_serving_grid(*args, backend="torch", device="cpu")
    monkeypatch.setattr(scan, "_TIER_Q", sys.maxsize)
    full_out, full_meta = scan.sweep_rows(*rows, device="cpu")
    assert full_meta["passes"] == 1
    for key in out:
        assert np.array_equal(out[key], full_out[key]), key
    full = run_serving_grid(*args, backend="torch", device="cpu")
    assert [r.to_dict() for r in tiered] == [r.to_dict() for r in full]
    # a device type outside _TIER_DEVICES (the card) runs the one
    # full-width pass at the default _TIER_Q
    monkeypatch.setattr(scan, "_TIER_Q", 16)
    monkeypatch.setattr(scan, "_TIER_DEVICES", ())
    untiered_out, untiered_meta = scan.sweep_rows(*rows, device="cpu")
    assert untiered_meta["passes"] == 1
    for key in out:
        assert np.array_equal(out[key], untiered_out[key]), key


def test_bucketed_matches_exact_shapes(cell, monkeypatch):
    # without buckets the sweep runs at the exact (S, Q, B, K) instead of
    # the pow2 buckets: different draw shapes, same distribution
    monkeypatch.setattr(scan, "_SHAPE_BUCKETS", False)
    exact = grid("work_exchange", ServingConfig(**CELL_CFG), "torch")[0]
    bucketed = cell["torch"]["work_exchange"]
    assert exact.to_dict() != bucketed.to_dict()
    assert exact.extra["units_admitted"] == bucketed.extra["units_admitted"]
    se = max(np.hypot(exact.t_comp_std, bucketed.t_comp_std)
             / np.sqrt(CELL_TRIALS), 1e-9)
    assert abs(exact.t_comp - bucketed.t_comp) <= 6 * se + 1e-12
    assert abs(exact.extra["p99"] - bucketed.extra["p99"]) \
        <= 6 * se + 1e-12


def test_censored_parity():
    # jobs too large to ever finish: both engines flag the horizon bound
    # instead of posing as a measurement
    cfg = ServingConfig(loads=(0.6,), slots=100, slot_dt=0.01)
    for backend in ("numpy", "torch"):
        rep = grid("fixed", cfg, backend, N=1_000_000, trials=4, seed=5)[0]
        assert rep.extra["latency_censored"] == 1.0
        assert rep.extra["censored_frac"] == 1.0
        assert rep.extra["p50"] == rep.extra["p99"] == pytest.approx(1.0)
        assert rep.t_comp == pytest.approx(1.0)


@pytest.mark.parametrize("kw", [
    dict(job_units_dist="geometric"),
    dict(admission="deadline", deadline_slo=2.0),
    dict(arrival="trace", arrival_params={"epochs": 12}),
    dict(exchange_every=4, max_queue_jobs=8)])
@pytest.mark.parametrize("name", ["work_exchange_unknown", "hedged",
                                  "het_mds", "gradient_coded"])
def test_modes_close_the_ledger_and_agree_with_numpy(name, kw):
    cfg = ServingConfig(loads=(0.5, 0.9), slots=300, **kw)
    sched = small_het().lambdas * RNG(2).uniform(0.5, 1.2, (5, 6))
    rows = {b: grid(name, cfg, b, N=12, trials=8,
                    rate_schedules=sched[None]) for b in ("numpy",
                                                          "torch")}
    for rn, rt in zip(rows["numpy"], rows["torch"]):
        assert closes_ledger(rt.extra)
        if kw.get("job_units_dist") != "geometric":
            assert rn.extra["offered_load"] == rt.extra["offered_load"]
            if rn.extra["reject_rate"] == 0 == rt.extra["reject_rate"]:
                assert rn.extra["units_admitted"] \
                    == rt.extra["units_admitted"]
        se = max(np.hypot(rn.t_comp_std, rt.t_comp_std) / np.sqrt(8),
                 1e-9)
        assert abs(rn.t_comp - rt.t_comp) <= 6 * se + 1e-12


def test_closed_loop_is_refused():
    cfg = ServingConfig(loads=(0.6,), slots=300, arrival="closed_loop",
                        arrival_params={"think_slots": 2})
    with pytest.raises(ValueError, match="[Cc]losed-loop"):
        grid("work_exchange", cfg, "torch", trials=2)


def test_an_adapter_without_a_device_form_raises(monkeypatch):
    # the reference drops such an adapter to the numpy sweep; here that
    # would run a device request on the host, so it raises
    monkeypatch.delitem(policies.POLICY_ADAPTERS, "work_exchange")
    with pytest.raises(NotImplementedError, match="GenericPolicy"):
        grid("work_exchange", ServingConfig(**CELL_CFG), "torch",
             trials=2)
    rep = grid("work_exchange", ServingConfig(**CELL_CFG), "numpy",
               trials=2)[0]
    assert "serving_backend" not in rep.extra


def test_the_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("numpy", "torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_serving_grid("fixed", {}, [small_het()],
                             ServingConfig(**CELL_CFG), CELL_N, 2,
                             CELL_SEED, backend=backend)
