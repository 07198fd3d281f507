"""The device axis of the port: ``grid_sharding``'s row split held
against the JAX package's sharded executor, on the CPU.

* One device is the unsplit path bit for bit, for the ``torch`` and
  ``cuda`` backends and the torch serving engine.
* The ``cuda`` backend split over D in {2, 4} CPU shards against the
  reference's ``pallas`` backend under ``grid_sharding(D)``, which runs
  in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count
  =4`` (there its CPU path, the jitted jnp oracle, runs per shard): rows
  agree as ``test_torch_cuda.py`` holds them (>= 99% of rows with equal
  iterations, ``t_comp`` rtol 1e-4 and ``n_comm`` rtol 1e-3 on those).
* The ``torch`` split is seed-deterministic and within 6 combined SE of
  the exact numpy engine; the serving split of fixed-size jobs, whose
  rows draw nothing on the device, is the unsplit sweep bit for bit.
* ``compile_plan`` resolves ``devices`` as the reference's does, at the
  same device count, and the CLI's ``--devices`` reaches the stored
  spec.

Every test runs under a hard limit (``HARD_LIMIT_S``).
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.experiments.__main__ import demo_spec as ref_demo_spec
from repro.experiments.plan import compile_plan as ref_compile_plan
from repro_torch.core import ExchangeConfig, HetSpec, get_scheme, \
    mc_grid_panel
from repro_torch.core.samplers import (active_grid_mesh, grid_devices,
                                       grid_sharding, shard_devices,
                                       work_exchange_grid_numpy)
from repro_torch.experiments import ResultsStore
from repro_torch.experiments.__main__ import demo_spec, main as cli_main
from repro_torch.experiments.plan import compile_plan
from repro_torch.serving import ServingConfig, run_serving_grid

from test_torch_cuda import assert_rows_agree

HARD_LIMIT_S = 120
REPO = Path(__file__).resolve().parents[1]
RNG = lambda s=0: np.random.default_rng(s)  # noqa: E731
K, N, TRIALS = 12, 30_000, 80
WE = ("work_exchange", "work_exchange_unknown")


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


def specs(G=3, seed=5):
    rng = RNG(seed)
    return [HetSpec.uniform_random(K, mu, mu * mu / 6, rng)
            for mu in (10.0, 20.0, 40.0)[:G]]


def schedule(G=3):
    lam = np.stack([h.lambdas for h in specs(G)])
    return lam[:, None, :] * np.exp(
        0.15 * RNG(9).standard_normal((G, 20, K)))


def rows_of(rep):
    return rep.t_comp_trials, rep.iterations_trials, rep.n_comm_trials


def port_case(case: str, rng):
    """One of the split cases on the port's ``cuda`` backend."""
    if case == "panel":
        out = mc_grid_panel({n: get_scheme(n) for n in WE}, specs(), N,
                            TRIALS, rng, keep_trials=True, backend="cuda",
                            device="cpu")
        return [rows_of(r) for n in WE for r in out[n]]
    name = "work_exchange" if case == "known" else "work_exchange_unknown"
    kw = {"rate_schedule": schedule()} if case == "drift" else {}
    return [rows_of(r) for r in get_scheme(name).mc_grid(
        specs(), N, TRIALS, rng, keep_trials=True, backend="cuda",
        device="cpu", **kw)]


CASES = ("known", "unknown", "drift", "panel")
REFERENCE_RUN = """
import json, sys
import numpy as np
import repro.core as rc
from repro.core.samplers import grid_sharding
from repro.core.schemes import mc_grid_panel
K, N, T = {K}, {N}, {T}
rng = np.random.default_rng(5)
specs = [rc.HetSpec.uniform_random(K, mu, mu * mu / 6, rng)
         for mu in (10.0, 20.0, 40.0)]
lam = np.stack([h.lambdas for h in specs])
sched = lam[:, None, :] * np.exp(
    0.15 * np.random.default_rng(9).standard_normal((3, 20, K)))
WE = ("work_exchange", "work_exchange_unknown")
rows = lambda r: [r.t_comp_trials.tolist(), r.iterations_trials.tolist(),
                  r.n_comm_trials.tolist()]
out = {{}}
for D in (2, 4):
    with grid_sharding(D) as mesh:
        assert mesh.size == D
        for case in ("known", "unknown", "drift", "panel"):
            rng = np.random.default_rng(100 + D)
            if case == "panel":
                res = mc_grid_panel({{n: rc.get_scheme(n) for n in WE}},
                                    specs, N, T, rng, keep_trials=True,
                                    backend="pallas")
                got = [rows(r) for n in WE for r in res[n]]
            else:
                name = WE[0] if case == "known" else WE[1]
                kw = {{"rate_schedule": sched}} if case == "drift" else {{}}
                got = [rows(r) for r in rc.get_scheme(name).mc_grid(
                    specs, N, T, rng, keep_trials=True, backend="pallas",
                    **kw)]
            out[f"{{D}}/{{case}}"] = got
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference_split():
    """The reference's sharded ``pallas`` rows for every case and D, from
    one subprocess with four CPU devices."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE_RUN.format(K=K, N=N, T=TRIALS)],
        capture_output=True, text=True, env=env, timeout=HARD_LIMIT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_cuda_split_matches_reference_sharded_pallas(reference_split, D,
                                                     case):
    with grid_sharding(D, device="cpu") as mesh:
        assert mesh == (torch.device("cpu"),) * D
        assert active_grid_mesh() == mesh
        ours = port_case(case, RNG(100 + D))
    assert active_grid_mesh() is None
    theirs = reference_split[f"{D}/{case}"]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert_rows_agree(a, b)


def test_cuda_split_keys_each_shard_from_its_own_seed_pair():
    """The ``(D, 2)`` draw's first pair is the unsplit draw's pair and
    every shard counts its rows from 0, so the first shard's rows are the
    unsplit run's; the second shard's come from another pair."""
    def t_comp(rows):
        return np.concatenate([r[0] for r in rows])

    whole = t_comp(port_case("known", RNG(7)))
    with grid_sharding(2, device="cpu"):
        split = t_comp(port_case("known", RNG(7)))
    per = 128                  # half of the 256-row bucket of 3 x 80 rows
    np.testing.assert_array_equal(whole[:per], split[:per])
    assert np.mean(whole[per:] == split[per:]) < 0.1


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("name", WE)
def test_one_device_is_the_unsplit_path(backend, name):
    def run():
        return get_scheme(name).mc_grid(
            specs(), N, TRIALS, RNG(3), keep_trials=True, backend=backend,
            rate_schedule=schedule(), device="cpu")

    whole = run()
    for devices in (1, ["cpu"]):
        with grid_sharding(devices, device="cpu") as mesh:
            assert len(mesh) == 1 and active_grid_mesh() is None
            one = run()
        for a, b in zip(whole, one):
            for x, y in zip(rows_of(a), rows_of(b)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("D", [2, 4])
def test_torch_split_is_deterministic_and_near_numpy(D):
    het = specs(1)[0]

    def run(seed):
        with grid_sharding(D, device="cpu"):
            return get_scheme("work_exchange_unknown").mc(
                het, N, 512, RNG(seed), keep_trials=True, backend="torch",
                device="cpu")

    a, b = run(11), run(11)
    np.testing.assert_array_equal(a.t_comp_trials, b.t_comp_trials)
    np.testing.assert_array_equal(a.n_comm_trials, b.n_comm_trials)
    t_np, _, _ = work_exchange_grid_numpy(
        het.lambdas[None, :], N, ExchangeConfig(known_heterogeneity=False),
        512, RNG(12))
    t = a.t_comp_trials
    se = np.hypot(t.std(), t_np.std()) / np.sqrt(t.size)
    assert abs(t.mean() - t_np.mean()) < max(6.0 * se, 2e-3 * t_np.mean())


@pytest.mark.parametrize("units", ["fixed", "geometric"])
def test_serving_split(units):
    """Fixed-size jobs draw nothing on the device, so a split sweep is
    the unsplit one bit for bit; geometric sizes draw from one generator
    per shard, so there the split is another stream: seed-deterministic
    and within 6 combined SE of the unsplit sweep."""
    cfg = ServingConfig(loads=(0.5, 0.9), slots=120, deadline_slo=4.0,
                        job_units_dist=units, backend="torch")

    def run(devices):
        with grid_sharding(devices, device="cpu"):
            return run_serving_grid("work_exchange", {}, specs(1), cfg, 40,
                                    16, 17, device="cpu")

    whole = run(1)
    for D in (2, 4):
        split = run(D)
        for a, b in zip(whole, split):
            if units == "fixed":
                assert a.to_dict() == b.to_dict()
                continue
            assert b.extra["serving_backend"] == "torch"
            se = np.hypot(a.t_comp_std, b.t_comp_std) / np.sqrt(16)
            assert abs(a.t_comp - b.t_comp) < 6.0 * se
        assert [r.to_dict() for r in run(D)] == [r.to_dict() for r in split]


def test_grid_devices_resolution():
    assert grid_devices(3, "cpu") == (torch.device("cpu"),) * 3
    assert grid_devices(None, "cpu") == (torch.device("cpu"),)
    assert grid_devices(["cpu", "cpu"], "cpu") == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="at least one"):
        grid_devices([], "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            grid_devices(2)


def test_grid_devices_start_at_the_named_card(monkeypatch):
    """A count of cards starts at the card ``device`` names and wraps
    round, and a grid call on a card outside the installed mesh raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert grid_devices(2, "cuda") == tuple(cards[:2])
    assert grid_devices(2, "cuda:1") == tuple(cards[1:3])
    assert grid_devices(3, "cuda:3") == (cards[3], cards[0], cards[1])
    assert grid_devices(None, "cuda:2") == tuple(cards[2:] + cards[:2])
    assert grid_devices(9, "cuda:0") == tuple(cards)
    with pytest.raises(ValueError, match="sees 4 CUDA"):
        grid_devices(2, "cuda:4")
    with grid_sharding(2, device="cuda:1") as mesh:
        assert mesh == tuple(cards[1:3])
        assert shard_devices("cuda:1") == mesh
        assert shard_devices("cuda") == mesh
        with pytest.raises(ValueError, match="does not match"):
            shard_devices("cuda:0")
        with pytest.raises(ValueError, match="does not match"):
            shard_devices("cpu")


# the reference's names of the port's backends and serving engines
REF_BACKEND = {"numpy": "numpy", "torch": "jax", "cuda": "pallas"}
SERVING_ENGINES = {kind: ((None, None),) for kind in
                   ("quick", "drifting", "live", "train")}
SERVING_ENGINES["serving"] = (("numpy", "numpy"), ("torch", "jax"))


@pytest.mark.parametrize("kind", ["quick", "drifting", "serving", "live",
                                  "train"])
def test_compile_plan_resolves_devices_as_the_reference(kind, monkeypatch):
    """At one device count (4 cards for the port, 4 jax devices for the
    reference), every backend x requested count x panel mode resolves to
    the same ``devices``; without cards the port resolves 1."""
    import jax
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * 4)
    for backend, ref_backend in REF_BACKEND.items():
        for devices in (1, 2, 4, 8, "auto"):
            for panel in (("per_scheme", "fused")
                          if kind in ("quick", "drifting")
                          else ("per_scheme",)):
                ours = demo_spec(kind).replace(backend=backend,
                                               devices=devices, panel=panel)
                theirs = ref_demo_spec(kind).replace(
                    backend=ref_backend, devices=devices, panel=panel)
                for engine, ref_engine in SERVING_ENGINES[kind]:
                    if engine is not None:
                        ours = ours.replace(serving=dataclasses.replace(
                            ours.serving, backend=engine))
                        theirs = theirs.replace(serving=dataclasses.replace(
                            theirs.serving, backend=ref_engine))
                    got = compile_plan(ours)
                    want = ref_compile_plan(theirs)
                    assert got.spec.devices == want.spec.devices, \
                        (kind, backend, devices, panel, engine)
                assert got.devices == got.spec.devices
                if backend == "numpy":
                    assert got.bucket_shape is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    plan = compile_plan(demo_spec("quick").replace(backend="torch",
                                                   devices="auto"))
    assert plan.spec.devices == 1


def test_bucket_shape_matches_the_reference():
    for backend, ref_backend in (("torch", "jax"), ("cuda", "pallas")):
        for kind in ("quick", "drifting"):
            got = compile_plan(demo_spec(kind).replace(backend=backend))
            want = ref_compile_plan(ref_demo_spec(kind).replace(
                backend=ref_backend))
            assert got.bucket_shape == want.bucket_shape


def test_cli_devices_reaches_the_stored_spec(tmp_path, monkeypatch, capsys):
    """``--devices 2`` on a host with (monkeypatched) four cards: the
    resolved count is stored, and on ``--device cpu`` the rows split over
    two CPU shards -- the same rows two cards give the ``cuda`` backend."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = ["--demo", "quick", "--backend", "cuda", "--trials", "8",
            "--device", "cpu", "--store", str(tmp_path)]
    assert cli_main(args + ["--devices", "2"]) == 0
    assert "devices=2" in capsys.readouterr().out
    assert cli_main(args + ["--devices", "auto"]) == 0
    store = ResultsStore(tmp_path)
    stored = sorted(store.get(h).spec.devices for h in store.entries())
    assert stored == [2, 4]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert cli_main(args + ["--devices", "4", "--force"]) == 0
    assert "devices=1" in capsys.readouterr().out
