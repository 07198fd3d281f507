"""The port's live control plane (``repro_torch.control``) side by side with
the JAX package's (``repro.control``), on the CPU.

* **Exact against the reference:** the registry helpers, the transport
  registry and its error text, ``LiveConfig.to_dict`` and its errors, the
  live spec hashes (``demo-live``, ``demo-live-fault``, ``quick --live``)
  and the stored live entry's address, ``_encode``'s frames, ``flaky``'s
  dropped messages for one seed, the payload's ``A`` and ``x`` bit for
  bit (``y`` at 1e-5 relative), a worker's drawn service clock,
  ``Telemetry.to_dict`` under one fake clock, ``live_supported`` for
  every scheme, and the coded path's ``n_comm`` and ``units_dispatched``.
* **Within the reference battery's band** (``tests/test_control.py``):
  ``work_exchange`` and ``fixed`` live against the JAX package's numpy
  Monte Carlo, ``|live - mc| < max(8 combined SE, 0.25 t_comp)``.
* The port alone: the transport conformance battery, drops that force
  retries, a killed worker whose units are reassigned, a ``tcp`` listener
  whose handler never closes its comm stopping within 1 s (the reference
  hangs there on Python >= 3.12.1), and live specs through
  ``run_experiment``.

Every test runs under its own hard limit (``HARD_LIMIT_S``, armed with
``signal.setitimer``): a hang fails that test instead of holding the
worker that runs it.
"""
import asyncio
import json
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.control as ref_control
import repro.control.compute as ref_compute
import repro.control.faults as ref_faults
import repro.control.tcp as ref_tcp
import repro.control.worker as ref_worker
import repro.core as ref_core
import repro.core.registry as ref_registry
from repro.experiments import ExperimentSpec as RefSpec
from repro.experiments.__main__ import demo_spec as ref_demo_spec
from repro_torch.control import (Comm, CommClosedError, LiveConfig,
                                 Telemetry, TRANSPORT_REGISTRY, get_transport,
                                 list_transports, run_live, run_live_grid)
from repro_torch.control import compute, coordinator, faults, tcp, worker
from repro_torch.control.coordinator import live_supported
from repro_torch.core import HetSpec, get_scheme, list_schemes
from repro_torch.core.registry import Registry
from repro_torch.experiments import (ExperimentSpec, ResultsStore,
                                     compile_plan, run_experiment,
                                     scheme_spec)
from repro_torch.experiments.__main__ import demo_spec

HARD_LIMIT_S = 30.0
ROOT = Path(__file__).resolve().parents[1]
STORE = ROOT / "results" / "store"
LIVE_ENTRY = "f8ff00118f49ebce9a9efb32b2f38d57202824878cea2972cbea8a9bd937ce88"
RNG = np.random.default_rng

# constructor params that make each registered transport a reliable
# channel, as the reference battery has them
RELIABLE_PARAMS = {"inproc": {}, "flaky": {"drop": 0.0, "seed": 0},
                   "tcp": {}}


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


def small_het(K=4, seed=2):
    return HetSpec.uniform_random(K, 4.0, 4.0 ** 2 / 6.0, RNG(seed))


def ref_small_het(K=4, seed=2):
    return ref_core.HetSpec.uniform_random(K, 4.0, 4.0 ** 2 / 6.0, RNG(seed))


def quick_cfg(**kw):
    kw.setdefault("target_wall_s", 0.15)
    return LiveConfig(**kw)


def raised(fn):
    """``(type name, message)`` of what ``fn()`` raises, or its value."""
    try:
        return fn()
    except Exception as e:      # the comparison is of the error itself
        return type(e).__name__, str(e)


def assert_ledger_conserves(rep):
    led = rep.extra["control_plane"]["ledger"]
    assert led["units_dispatched"] == (led["units_completed"]
                                       + led["units_reassigned"])
    return led


# ---------------------------------------------------------------------------
# registry, transports and LiveConfig: exact against the reference
# ---------------------------------------------------------------------------

def test_registry_canonical_aliases_and_delitem_match_the_reference():
    def drive(cls):
        reg = cls("widget")
        reg.register("a", 1, aliases=("alpha", "first"))
        reg.register("b", 2)
        out = [reg.canonical("alpha"), reg.canonical("b"), reg.aliases(),
               reg.names(include_aliases=True)]
        del reg["a"]
        out += [reg.canonical("alpha"), reg.aliases(), list(reg),
                raised(lambda: reg.__delitem__("zz"))]
        return out
    assert drive(Registry) == drive(ref_registry.Registry)


def test_transport_registry_matches_the_reference():
    assert list_transports() == ref_control.list_transports()
    assert (list_transports(include_aliases=True)
            == ref_control.list_transports(include_aliases=True))
    assert TRANSPORT_REGISTRY.aliases() == {"faulty": "flaky"}
    assert TRANSPORT_REGISTRY.get("faulty") is TRANSPORT_REGISTRY.get("flaky")


@pytest.mark.parametrize("name, params", [
    ("definitely_missing", {}), ("inproc", {"nope": 1}),
    ("flaky", {"drop": 0.1, "bogus": 2}), ("tcp", {"port": 1})])
def test_get_transport_errors_match_the_reference(name, params):
    ours = raised(lambda: get_transport(name, **params))
    theirs = raised(lambda: ref_control.get_transport(name, **params))
    assert ours == theirs and ours[0] == "KeyError"


@pytest.mark.parametrize("kw", [
    {}, {"target_wall_s": 0.5},
    {"transport": "flaky", "transport_params": {"drop": 0.1, "seed": 5},
     "target_wall_s": 0.25, "kill_worker": 1},
    {"transport": "faulty", "transport_params": (("seed", 3),
                                                 ("inner", "tcp"))},
    {"time_scale": 2, "timeout_s": 0.1, "retries": 1, "backoff": 2,
     "poll_s": 0.01, "unit_rows": 8, "unit_dim": 16,
     "kill_after_frac": 1}], ids=range(5))
def test_live_config_to_dict_is_the_reference(kw):
    ours, theirs = LiveConfig(**kw), ref_control.LiveConfig(**kw)
    assert json.dumps(ours.to_dict()) == json.dumps(theirs.to_dict())
    assert LiveConfig.from_dict(json.loads(json.dumps(
        ours.to_dict()))) == ours
    assert ours.resolve_time_scale(100.0) == theirs.resolve_time_scale(100.0)


@pytest.mark.parametrize("kw", [
    {"target_wall_s": 0.0}, {"time_scale": -1.0}, {"retries": -1},
    {"backoff": 0.5}, {"kill_after_frac": 0.0}, {"unit_rows": 0},
    {"poll_s": 0.0}, {"kill_worker": -1}, {"transport": "carrier_pigeon"},
    {"transport": "inproc", "transport_params": {"nope": 1}},
    {"transport": "flaky", "transport_params": {"drop": 1.0}}],
    ids=range(11))
def test_live_config_errors_match_the_reference(kw):
    ours = raised(lambda: LiveConfig(**kw))
    assert ours == raised(lambda: ref_control.LiveConfig(**kw))
    assert ours[0] in ("KeyError", "ValueError")


def test_live_config_from_dict_errors_match_the_reference():
    bad = {"transport": "inproc", "wat": 1}
    ours = raised(lambda: LiveConfig.from_dict(bad))
    assert ours == raised(lambda: ref_control.LiveConfig.from_dict(bad))
    assert "unknown live key" in ours[1]


# ---------------------------------------------------------------------------
# live specs: hashes, the stored entry, the value discipline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind, live", [("live", False),
                                        ("live-fault", False),
                                        ("quick", True)])
def test_live_demo_specs_hash_as_the_reference(kind, live):
    ours, theirs = demo_spec(kind), ref_demo_spec(kind)
    if live:            # the CLI's --live override
        ours = ours.replace(execution="live")
        theirs = theirs.replace(execution="live")
    assert ours.to_dict() == theirs.to_dict()
    assert ours.spec_hash() == theirs.spec_hash()
    assert ExperimentSpec.from_json(ours.to_json()) == ours


def test_stored_live_entry_reads_back_at_its_address():
    d = json.loads((STORE / f"{LIVE_ENTRY}.json").read_text())
    spec = ExperimentSpec.from_dict(d["spec"])
    assert spec.spec_hash() == LIVE_ENTRY
    assert spec.to_dict() == d["spec"]
    assert spec.spec_hash() == RefSpec.from_dict(d["spec"]).spec_hash()
    got = ResultsStore(STORE).get(LIVE_ENTRY)
    assert got is not None and got.spec == spec
    assert got.to_dict()["reports"] == d["reports"]
    # the resolved spec keeps the stored backend, so it compiles to the
    # stored address
    assert compile_plan(spec).spec_hash == LIVE_ENTRY


@pytest.mark.parametrize("kw", [
    dict(execution="warp"), dict(live=LiveConfig()),
    dict(execution="live", live={"transport": "inproc"}),
    dict(execution="live", panel="fused"),
    dict(execution="live", serving="SERVING"),
    dict(execution="live", training="TRAINING")], ids=range(6))
def test_live_spec_errors_match_the_reference(kw):
    from repro.hettrain import TrainConfig as RefTrain
    from repro.serving import ServingConfig as RefServing
    from repro_torch.hettrain import TrainConfig
    from repro_torch.serving import ServingConfig

    def build(live_cls, serving, training, demo):
        args = dict(kw)
        if isinstance(args.get("live"), LiveConfig):
            args["live"] = live_cls()
        if args.get("serving") == "SERVING":
            args["serving"] = serving(loads=(0.5,))
        if args.get("training") == "TRAINING":
            args["training"] = training()
        return lambda: demo("quick").replace(**args)

    ours = raised(build(LiveConfig, ServingConfig, TrainConfig, demo_spec))
    theirs = raised(build(ref_control.LiveConfig, RefServing, RefTrain,
                          ref_demo_spec))
    assert ours == theirs and ours[0] in ("TypeError", "ValueError")


def test_execution_live_defaults_live_config_and_omits_keys_at_mc():
    spec = demo_spec("quick").replace(execution="live")
    assert spec.live == LiveConfig()
    back = spec.replace(execution="mc", live=None)
    assert "execution" not in back.to_dict() and "live" not in back.to_dict()
    assert back.spec_hash() == demo_spec("quick").spec_hash()


# ---------------------------------------------------------------------------
# wire, faults, payload, worker clock, telemetry: exact
# ---------------------------------------------------------------------------

MESSAGES = [
    {"type": "hello", "worker": np.int64(3)},
    {"type": "assign", "round": np.int32(2), "units": [1, 2, 3], "seq": 7},
    {"type": "reply", "seq": 9, "done": np.int64(11), "running": False},
    {"ledger": {"units": np.int64(5), "flops": np.float64(1.5e9)},
     "rates": np.array([1.0, 2.5]), "t": np.float32(0.25)},
    {"round_done": True, "text": "über", "none": None}]


@pytest.mark.parametrize("msg", MESSAGES, ids=range(len(MESSAGES)))
def test_encode_is_the_reference_bytes(msg):
    assert tcp._encode(msg) == ref_tcp._encode(msg)


def test_encode_rejects_what_the_reference_rejects():
    bad = {"x": object()}
    assert raised(lambda: tcp._encode(bad)) == raised(
        lambda: ref_tcp._encode(bad))


class Recorder:
    """An inner comm that records what reaches it."""

    def __init__(self):
        self.got = []

    async def send(self, msg):
        self.got.append(msg["i"])


@pytest.mark.parametrize("drop, jitter, seed", [(0.2, 0.0, 3),
                                                (0.5, 0.0, 11),
                                                (0.3, 1e-6, 7)])
def test_flaky_drops_the_reference_messages(drop, jitter, seed):
    def delivered(FlakyComm):
        rec = Recorder()
        comm = FlakyComm(rec, RNG(seed), 0.0, jitter, drop)

        async def main():
            for i in range(200):
                await comm.send({"i": i})
        asyncio.run(main())
        return rec.got, comm.dropped
    got, dropped = delivered(faults.FlakyComm)
    assert (got, dropped) == delivered(ref_faults.FlakyComm)
    assert got[0] == 0 and 0 < dropped < 200     # the handshake survives


@pytest.mark.parametrize("units, rows, dim, seed", [(37, 4, 64, 0),
                                                   (300, 2, 16, 5)])
def test_payload_draws_the_reference_bits_and_products(units, rows, dim,
                                                       seed, monkeypatch):
    monkeypatch.setattr(compute, "_DRAW_ROWS", 7)    # several chunks
    ours = compute.MatmulPayload(units, rows, dim, seed=seed, device="cpu")
    theirs = ref_compute.MatmulPayload(units, rows, dim, seed=seed)
    assert ours.A.shape == (units, rows, dim)
    assert np.array_equal(ours.A.reshape(-1, dim).numpy(), theirs.A)
    assert np.array_equal(ours.x.numpy(), theirs.x)
    for ids in ([0], [5, 3, 1], list(range(units - 20, units)),
                list(range(units))):
        assert ours.compute(ids) == theirs.compute(ids)
    assert ours.flops == theirs.flops
    assert np.array_equal(ours.done, theirs.done)
    y_ours = ours.y.reshape(-1).numpy()
    np.testing.assert_allclose(y_ours, theirs.y, rtol=1e-5, atol=1e-5)
    assert ours.verify() and ours.device_ms() is None


def test_payload_warmup_resets_and_verify_catches_a_wrong_block():
    p = compute.MatmulPayload(50, 4, 8, seed=1, device="cpu")
    p.warmup(64)
    assert p.flops == 0 and not p.done.any() and p.verify()
    assert p.compute([]) == (0, 0)
    p.compute([4, 9])
    assert p.flops == 2 * 4 * 8 and p.verify()
    p.y[9, 2] += 1.0
    assert not p.verify()


@pytest.mark.parametrize("rate, seed, n", [(4.0, 0, 50), (0.7, 1234 * 100003,
                                                          300)])
def test_worker_draws_the_reference_service_clock(rate, seed, n):
    def clock(Worker):
        w = Worker(None, "inproc://x", 2, rate=rate, time_scale=0.01,
                   payload=None, seed=seed)

        async def main():
            cums = []
            for units in (list(range(n)), [], list(range(n // 3))):
                w._start_round(len(cums), units)
                w._round_task.cancel()      # before it reaches the payload
                cums.append(w._cum.copy())
            return cums
        return asyncio.run(main())
    for a, b in zip(clock(worker.Worker), clock(ref_worker.Worker)):
        assert np.array_equal(a, b)


def test_telemetry_to_dict_matches_the_reference(monkeypatch):
    def timeline(Tel):
        ticks = iter(np.arange(0.0, 10.0, 0.0371))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        tel = Tel(max_events=5)
        tel.start()
        for w in range(3):
            tel.span_open(w, "idle")
        tel.count("units_dispatched", 10)
        tel.count("units_dispatched", np.int64(5))
        for i in range(8):
            tel.event("e", i=i, worker=i % 3)
        tel.span_open(0, "busy", round=0)
        tel.span_close(0, units=7)
        tel.span_open(1, "busy", round=0)
        tel.span_open(1, "idle")
        tel.span_close(2, units=3)
        return tel.to_dict(events_tail=3)
    ours = timeline(Telemetry)
    assert ours == timeline(ref_control.Telemetry)
    assert ours["n_events"] == 8 and len(ours["events"]) == 3


@pytest.mark.parametrize("name", list_schemes())
def test_live_supported_matches_the_reference(name):
    assert list_schemes() == ref_core.list_schemes()
    ours = raised(lambda: live_supported(get_scheme(name)))
    theirs = raised(lambda: ref_control.coordinator.live_supported(
        ref_core.get_scheme(name)))
    assert ours == theirs


# ---------------------------------------------------------------------------
# live runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, params", [("mds", {"L": 3}), ("hedged", {})])
def test_coded_path_ships_the_reference_units(name, params):
    N = 600
    ours = run_live(name, params, small_het(), N, quick_cfg(target_wall_s=0.1),
                    trials=2, seed=5, device="cpu")
    theirs = ref_control.run_live(name, params, ref_small_het(), N,
                                  ref_control.LiveConfig(target_wall_s=0.1),
                                  trials=2, seed=5)
    assert ours.n_comm == theirs.n_comm == float(
        get_scheme(name, **params).initial_sizes(small_het(), N).sum() - N)
    led = assert_ledger_conserves(ours)
    ref_led = theirs.extra["control_plane"]["ledger"]
    assert led["units_dispatched"] == ref_led["units_dispatched"] > 2 * N
    assert ours.iterations == 1 and ours.t_comp > 0
    cp = ours.extra["control_plane"]
    assert cp["payload_backend"] == "torch" and cp["payload_device_ms"] is None
    assert set(cp) == set(theirs.extra["control_plane"]) | {
        "payload_device_ms"}


@pytest.mark.parametrize("name", ["work_exchange", "fixed"])
def test_live_matches_the_reference_mc_within_the_band(name):
    N = 800
    rep = run_live(name, {}, small_het(), N, quick_cfg(), trials=3, seed=7,
                   device="cpu")
    mc = ref_core.get_scheme(name).mc(ref_small_het(), N, 400, RNG(0))
    se = np.hypot(rep.t_comp_std / np.sqrt(3), mc.t_comp_std / 20.0)
    assert abs(rep.t_comp - mc.t_comp) < max(8.0 * se, 0.25 * mc.t_comp)
    led = assert_ledger_conserves(rep)
    assert led["units_completed"] == 3 * N
    if name == "fixed":
        assert rep.iterations == 1 and led["units_reassigned"] == 0
    else:
        assert rep.iterations >= 2           # it actually exchanged
    json.dumps(rep.extra["control_plane"])   # JSON-safe


def test_stored_live_entry_coded_rows_rerun_to_the_stored_n_comm():
    d = json.loads((STORE / f"{LIVE_ENTRY}.json").read_text())
    spec = ExperimentSpec.from_dict(d["spec"])
    het = spec.grid.specs()[0]
    cfg = spec.live.__class__(**{**spec.live.to_dict(),
                                 "target_wall_s": 0.1})
    for s in spec.schemes:
        if s.scheme not in ("mds", "hedged"):
            continue
        rep = run_live(s.scheme, s.params_dict, het, spec.N, cfg, trials=1,
                       seed=spec.seed, device="cpu")
        stored = d["reports"][s.report_key][0]
        assert rep.n_comm == stored["n_comm"]
        assert rep.iterations == stored["iterations"] == 1
        assert_ledger_conserves(rep)


# ---------------------------------------------------------------------------
# the port alone: transports, faults, the stop repair, the experiment layer
# ---------------------------------------------------------------------------

def echo_handler():
    async def handle(comm: Comm):
        while True:
            try:
                msg = await comm.recv()
            except (CommClosedError, asyncio.CancelledError):
                return
            await comm.send({"echo": msg})
    return handle


@pytest.mark.parametrize("name", list_transports())
def test_echo_round_trip_and_fifo(name):
    async def main():
        tr = get_transport(name, **RELIABLE_PARAMS[name])
        assert tr.name == name
        listener = tr.listen(echo_handler())
        await listener.start()
        comm = await tr.connect(listener.address)
        await comm.send({"x": 1, "payload": [1, 2, 3]})
        assert await comm.recv(timeout=2.0) == {
            "echo": {"x": 1, "payload": [1, 2, 3]}}
        for i in range(20):
            await comm.send({"i": i})
        got = [(await comm.recv(timeout=2.0))["echo"]["i"]
               for _ in range(20)]
        assert got == list(range(20))
        await comm.close()
        await asyncio.wait_for(listener.stop(), 1.0)
    asyncio.run(main())


@pytest.mark.parametrize("name", list_transports())
def test_recv_timeout_and_peer_close(name):
    async def main():
        async def close_at_once(comm):
            await comm.close()
        tr = get_transport(name, **RELIABLE_PARAMS[name])
        listener = tr.listen(echo_handler())
        await listener.start()
        comm = await tr.connect(listener.address)
        with pytest.raises(asyncio.TimeoutError):
            await comm.recv(timeout=0.05)
        await asyncio.wait_for(listener.stop(), 1.0)
        closer = tr.listen(close_at_once)
        await closer.start()
        comm = await tr.connect(closer.address)
        with pytest.raises(CommClosedError):
            await comm.recv(timeout=2.0)
        await asyncio.wait_for(closer.stop(), 1.0)
    asyncio.run(main())


@pytest.mark.parametrize("inner", ["inproc", "tcp"])
def test_tcp_stop_returns_though_a_handler_never_closes_its_comm(inner):
    """The reference's ``TCPListener.stop`` hangs here on Python >= 3.12.1
    (``Server.wait_closed`` waits for the open accepted connection)."""
    async def main():
        accepted = []

        async def stuck(comm):
            accepted.append(comm)
            await comm.send({"hi": 1})
            await asyncio.sleep(3600)       # never closes its comm

        async def leaves(comm):
            accepted.append(comm)
            await comm.recv()               # returns without closing

        tr = get_transport("flaky", inner=inner, seed=0)
        for handler in (stuck, leaves, echo_handler()):
            listener = tr.listen(handler)
            await listener.start()
            client = await tr.connect(listener.address)
            await client.send({"go": 1})
            if handler is stuck:
                assert await client.recv(timeout=2.0) == {"hi": 1}
            elif handler is not leaves:
                assert await client.recv(timeout=2.0) == {"echo": {"go": 1}}
            await asyncio.sleep(0.01)
            t0 = time.perf_counter()
            await asyncio.wait_for(listener.stop(), 1.0)
            assert time.perf_counter() - t0 < 1.0
            if inner == "tcp":      # the client sees the close
                with pytest.raises(CommClosedError):
                    await client.recv(timeout=1.0)
        assert len(accepted) == 2
    asyncio.run(main())


def test_injected_drops_trigger_retries_and_still_complete():
    N = 500
    cfg = quick_cfg(transport="flaky",
                    transport_params={"drop": 0.2, "seed": 3},
                    timeout_s=0.1, retries=4)
    rep = run_live("work_exchange", {}, small_het(), N, cfg, trials=1,
                   seed=2, device="cpu")
    cp = rep.extra["control_plane"]
    assert cp["timeline"]["counters"].get("rpc_retries", 0) > 0
    led = assert_ledger_conserves(rep)
    assert led["units_completed"] == N and rep.t_comp > 0


def test_worker_loss_reassigns_leftovers():
    N = 800
    cfg = quick_cfg(target_wall_s=0.3, timeout_s=0.05, retries=1,
                    kill_worker=0, kill_after_frac=0.2)
    rep = run_live("work_exchange", {}, small_het(), N, cfg, trials=1,
                   seed=4, device="cpu")
    cp = rep.extra["control_plane"]
    assert cp["workers_lost"] == [0]
    led = assert_ledger_conserves(rep)
    assert led["units_completed"] == N      # degraded, not hung
    assert led["units_reassigned"] > 0      # the dead worker's units


def test_tcp_live_episode_completes():
    rep = run_live("work_exchange", {}, small_het(), 400,
                   quick_cfg(transport="tcp"), trials=1, seed=1,
                   device="cpu")
    led = assert_ledger_conserves(rep)
    assert led["units_completed"] == 400
    assert rep.extra["control_plane"]["transport"] == "tcp"


def test_episodes_pause_the_collector_and_restore_it(monkeypatch):
    """The cyclic collector is off inside an episode (a full collection
    walks every unit-id list and stalls the event loop) and back on after
    it, also when it raises."""
    import gc
    seen = []
    real = worker.Worker._start_round

    def spy(self, rnd, units):
        seen.append(gc.isenabled())
        return real(self, rnd, units)

    monkeypatch.setattr(worker.Worker, "_start_round", spy)
    run_live("fixed", {}, small_het(), 200, quick_cfg(target_wall_s=0.05),
             trials=1, seed=3, device="cpu")
    assert seen and not any(seen) and gc.isenabled()

    async def boom(self, sched):
        raise RuntimeError("boom")

    monkeypatch.setattr(coordinator.Coordinator, "run_exchange", boom)
    with pytest.raises(RuntimeError, match="boom"):
        run_live("fixed", {}, small_het(), 200, quick_cfg(), trials=1,
                 device="cpu")
    assert gc.isenabled()


def test_occupancy_tracks_rates():
    rep = run_live("fixed", {}, HetSpec(np.array([1.0, 4.0])), 400,
                   quick_cfg(), trials=1, seed=9, device="cpu")
    occ = rep.extra["control_plane"]["timeline"]["occupancy"]
    assert (occ["1"]["throughput_units_per_s"]
            > 2.0 * occ["0"]["throughput_units_per_s"])
    assert occ["0"]["units_done"] + occ["1"]["units_done"] == 400


def live_exp_spec(**kw):
    kw.setdefault("execution", "live")
    kw.setdefault("live", LiveConfig(target_wall_s=0.12))
    from repro_torch.experiments import ScenarioGrid
    return ExperimentSpec(
        name="live-int",
        grid=ScenarioGrid(K=3, points=[(4.0, 4.0 ** 2 / 6, 3)]),
        schemes=(scheme_spec("work_exchange"), scheme_spec("fixed")),
        N=400, trials=2, seed=21, **kw)


def test_compile_plan_pins_one_device_and_refuses_what_cannot_run_live():
    plan = compile_plan(live_exp_spec(devices="auto"))
    assert plan.spec.devices == 1 and plan.spec.backend == "cuda"
    bad = live_exp_spec().replace(schemes=(scheme_spec("gradient_coded"),))
    with pytest.raises(ValueError, match="cannot run live"):
        compile_plan(bad)


def test_run_experiment_live_store_round_trip(tmp_path):
    store = ResultsStore(tmp_path / "store")
    spec = live_exp_spec()
    first = run_experiment(spec, store=store, device="cpu")
    assert not first.cache_hit and first.env["device"] == "cpu"
    for key in ("work_exchange", "fixed"):
        [row] = first.report(key)
        assert row.extra["control_plane"]["transport"] == "inproc"
        assert assert_ledger_conserves(row)["units_completed"] == 2 * 400
    second = run_experiment(spec, store=store, device="cpu")
    assert second.cache_hit
    assert second.to_dict()["reports"] == first.to_dict()["reports"]


def test_default_device_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_live("fixed", {}, small_het(), 100, quick_cfg(), trials=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_live_grid("fixed", {}, [small_het()], 100, quick_cfg(), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute.MatmulPayload(10, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(live_exp_spec())
