"""Live coordinator: executes registry schemes over a real transport.
The port of ``repro.control.coordinator``.

The ``Coordinator`` is the asyncio master of one live episode.  It owns
a transport ``Listener``, handshakes K in-process ``Worker`` tasks, and
then drives one of two execution paths -- BOTH reusing the existing
schemes' planning logic, with zero new policy code:

* **exchange path** -- any scheme with ``make_scheduler`` (work_exchange,
  work_exchange_unknown, fixed, uniform, trace_replay): the paper's
  stop-flag protocol over real messages.  Each round, the
  ``MasterScheduler``'s queues are shipped via ``assign`` RPCs; the
  coordinator waits for the first ``round_done`` push (all of them when
  ``wait_all``), broadcasts ``stop``, collects per-worker done counts,
  and feeds them back through ``sched.report`` -- so estimation,
  thresholds, and N_comm accounting are exactly the simulated
  protocol's.
* **coded path** -- redundant schemes flagged ``live_cover`` (mds,
  het_mds, hedged): one shot of ``scheme.plan``'s queues, complete at
  the earliest instant the fully-finished workers' assigned sizes cover
  N (het_mds's cover rule; equals hedged's replica race exactly, and
  MDS's L-th order statistic whenever ceil(N/m) == L).

Fault handling: every RPC retries with exponential backoff
(``timeout_s * backoff**attempt``); a worker that exhausts its budget is
declared lost, its last polled done count stands as its contribution,
and ``sched.mark_failed`` returns its leftover units to the pool for
reassignment -- the episode completes degraded rather than hanging.

``run_live``/``run_live_grid`` are the synchronous entry points: one
fresh event loop per episode, ``MCReport`` out, with the telemetry
timeline and the conservation ledger in ``extra["control_plane"]``.
Both take ``device=`` (default ``"cuda"``, which raises without a card)
for the workers' matmul payload; ``device="cpu"`` runs the same code on
the CPU.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import itertools
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

import torch

from ..core.exchange import Assignment, MasterScheduler
from ..core.schemes import MCReport, _report, get_scheme
from ..core.types import HetSpec
from ..device import DEFAULT_DEVICE, resolve_device

from .compute import MatmulPayload
from .config import LiveConfig
from .telemetry import Telemetry
from .transport import Comm, CommClosedError
from .worker import Worker


class WorkerLost(Exception):
    """An RPC to this worker exhausted its timeout/retry budget."""

    def __init__(self, wid: int):
        super().__init__(f"worker {wid} lost (retries exhausted)")
        self.wid = wid


class WorkerProxy:
    """Coordinator-side handle for one worker's comm."""

    def __init__(self, wid: int, comm: Comm, cfg: LiveConfig,
                 telemetry: Telemetry, push_sink: "asyncio.Queue",
                 seq_counter):
        self.wid = wid
        self.comm = comm
        self.cfg = cfg
        self.tel = telemetry
        self.push_sink = push_sink
        self.seq = seq_counter
        self.lost = False
        self.last_done = 0            # freshest progress seen via poll
        self._pending: Dict[int, asyncio.Future] = {}
        self._recv_task = asyncio.ensure_future(self._recv_loop())

    async def _recv_loop(self) -> None:
        try:
            while True:
                msg = await self.comm.recv()
                self.tel.count("messages_received")
                if msg.get("type") == "reply":
                    fut = self._pending.pop(msg.get("seq"), None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
                else:
                    # stamp ARRIVAL time: round-end detection must not be
                    # skewed by how long the round loop took to drain
                    self.push_sink.put_nowait((self.wid, msg,
                                               self.tel.now()))
        except (CommClosedError, asyncio.CancelledError):
            pass

    async def rpc(self, msg: Dict) -> Dict:
        """Send, await the matching reply; retry with backoff; raise
        ``WorkerLost`` when the budget is gone."""
        if self.lost:
            raise WorkerLost(self.wid)
        seq = next(self.seq)
        msg = {**msg, "seq": seq}
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        timeout = float(self.cfg.timeout_s)
        try:
            for attempt in range(int(self.cfg.retries) + 1):
                if attempt:
                    self.tel.count("rpc_retries")
                    self.tel.event("rpc_retry", worker=self.wid,
                                   rpc=msg["type"], attempt=attempt)
                try:
                    await self.comm.send(msg)
                    self.tel.count("messages_sent")
                except CommClosedError:
                    break
                try:
                    # shield: a reply raced from an earlier attempt must
                    # still be able to land on this future
                    return await asyncio.wait_for(asyncio.shield(fut),
                                                  timeout)
                except asyncio.TimeoutError:
                    timeout *= float(self.cfg.backoff)
        finally:
            self._pending.pop(seq, None)
        self.lost = True
        self.tel.event("worker_lost", worker=self.wid, rpc=msg["type"])
        self.tel.count("workers_lost")
        raise WorkerLost(self.wid)

    async def close(self) -> None:
        self._recv_task.cancel()
        try:
            await self.comm.close()
        except CommClosedError:
            pass


@dataclasses.dataclass
class EpisodeStats:
    """One live episode's measured outcome (model units + wall split)."""
    t_comp: float                 # measured, model seconds
    iterations: int
    n_comm: float
    episode_wall_s: float         # first dispatch -> episode complete
    rounds_wall_s: float          # sum of in-round walls
    lost_workers: List[int]
    ledger: Dict[str, int]
    payload_device_ms: Optional[float] = None   # set after the episode

    @property
    def coordination_wall_s(self) -> float:
        return max(self.episode_wall_s - self.rounds_wall_s, 0.0)


class Coordinator:
    """Master of one live episode over a pluggable transport."""

    def __init__(self, het: HetSpec, cfg: LiveConfig, time_scale: float,
                 payload: MatmulPayload, telemetry: Telemetry,
                 seed: int = 0, expected_wall_s: Optional[float] = None):
        self.het = het
        self.K = het.K
        self.cfg = cfg
        self.time_scale = float(time_scale)
        self.payload = payload
        self.tel = telemetry
        self.seed = int(seed)
        self.expected_wall_s = (float(expected_wall_s)
                                if expected_wall_s is not None
                                else float(cfg.target_wall_s))
        self.transport = cfg.build_transport()
        self.proxies: Dict[int, WorkerProxy] = {}
        self.pushes: asyncio.Queue = asyncio.Queue()
        self._seq = itertools.count()
        self._hello_done: Optional[asyncio.Future] = None
        self._worker_tasks: List[asyncio.Future] = []
        self.listener = None

    # -- lifecycle ----------------------------------------------------------

    async def _handle_comm(self, comm: Comm) -> None:
        msg = await comm.recv()
        if msg.get("type") != "hello":
            await comm.close()
            return
        wid = int(msg["worker"])
        self.proxies[wid] = WorkerProxy(wid, comm, self.cfg, self.tel,
                                        self.pushes, self._seq)
        self.tel.event("hello", worker=wid)
        if (self._hello_done is not None and not self._hello_done.done()
                and len(self.proxies) == self.K):
            self._hello_done.set_result(None)

    async def start(self) -> None:
        self._hello_done = asyncio.get_running_loop().create_future()
        self.listener = self.transport.listen(self._handle_comm)
        await self.listener.start()
        for wid in range(self.K):
            die_after = None
            if (self.cfg.kill_worker is not None
                    and int(self.cfg.kill_worker) == wid):
                die_after = (float(self.cfg.kill_after_frac)
                             * self.expected_wall_s)
            w = Worker(self.transport, self.listener.address, wid,
                       rate=float(self.het.lambdas[wid]),
                       time_scale=self.time_scale, payload=self.payload,
                       seed=self.seed * 100003 + wid, telemetry=self.tel,
                       die_after=die_after)
            self._worker_tasks.append(asyncio.ensure_future(w.run()))
        # hellos ride the (possibly flaky) transport too: bound the wait
        await asyncio.wait_for(self._hello_done,
                               10.0 * self.cfg.timeout_s * self.K)

    async def shutdown(self) -> None:
        for proxy in self.proxies.values():
            if not proxy.lost:
                try:
                    await proxy.rpc({"type": "shutdown"})
                except WorkerLost:
                    pass
        for proxy in self.proxies.values():
            await proxy.close()
        if self.listener is not None:
            await self.listener.stop()
        for t in self._worker_tasks:
            t.cancel()
        await asyncio.gather(*self._worker_tasks, return_exceptions=True)

    # -- round machinery ----------------------------------------------------

    async def _dispatch(self, rnd: int, queues: List[List[int]],
                        ledger: Dict[str, int]) -> Tuple[Set[int], Set[int]]:
        """Assign nonempty queues; returns (participants, lost_at_assign)."""
        participants = {k for k, q in enumerate(queues)
                        if q and k in self.proxies
                        and not self.proxies[k].lost}
        for k in participants:
            # a stale count from an earlier round must never be credited
            # to this one (a worker lost at assign contributes zero)
            self.proxies[k].last_done = 0
        # the queue ships as the scheduler built it, not copied: nothing
        # mutates it after ``next_assignment`` (nor a message after send),
        # and at 1e6 units a copy is a pass over Python ints that delays
        # every later worker's start (the reference copies)
        results = await asyncio.gather(
            *(self.proxies[k].rpc({"type": "assign", "round": rnd,
                                   "units": queues[k]})
              for k in sorted(participants)),
            return_exceptions=True)
        lost = {k for k, res in zip(sorted(participants), results)
                if isinstance(res, WorkerLost)}
        for k in sorted(participants):
            ledger["units_dispatched"] += len(queues[k])
        self.tel.event("round_start", round=rnd,
                       sizes=[len(q) for q in queues])
        return participants, lost

    async def _await_round(self, rnd: int, queues: List[List[int]],
                           pending: Set[int], wait_all: bool,
                           cover_target: Optional[int] = None,
                           sizes: Optional[np.ndarray] = None
                           ) -> Tuple[Set[int], Set[int], float]:
        """Wait until the round's end condition; returns
        ``(finished, lost, t_end)`` with ``t_end`` the detection time.

        End conditions: first finisher (exchange round), all finishers
        (``wait_all``), or -- when ``cover_target`` is set -- the first
        instant the finished workers' ``sizes`` sum to the target."""
        finished: Set[int] = set()
        lost: Set[int] = set()
        t_end = self.tel.now()

        def end_reached() -> bool:
            if not (pending - finished - lost):
                return True          # nobody left running
            if cover_target is not None:
                return sum(int(sizes[k]) for k in finished) >= cover_target
            if wait_all:
                return False
            return bool(finished)

        while not end_reached():
            try:
                wid, msg, t_arrived = await asyncio.wait_for(
                    self.pushes.get(), self.cfg.poll_s)
                if (msg.get("type") == "round_done"
                        and msg.get("round") == rnd and wid in pending):
                    finished.add(wid)
                    self.proxies[wid].last_done = int(msg["done"])
                    t_end = t_arrived
                    self.tel.event("round_done", worker=wid, round=rnd,
                                   done=int(msg["done"]))
                else:
                    self.tel.count("stale_pushes")
                continue             # drain pushes before polling again
            except asyncio.TimeoutError:
                pass
            # poll survivors in parallel: liveness probe + dropped-push
            # recovery, bounded by ONE rpc budget rather than K of them
            targets = sorted(pending - finished - lost)
            replies = await asyncio.gather(
                *(self.proxies[k].rpc({"type": "poll"}) for k in targets),
                return_exceptions=True)
            for k, r in zip(targets, replies):
                if isinstance(r, WorkerLost):
                    lost.add(k)
                    continue
                if isinstance(r, BaseException):
                    raise r
                if r.get("round") != rnd:
                    continue
                self.proxies[k].last_done = int(r["done"])
                if not r.get("running") and int(r["done"]) == len(queues[k]):
                    finished.add(k)
                    t_end = self.tel.now()
                    self.tel.event("round_done_via_poll", worker=k,
                                   round=rnd, done=int(r["done"]))
        return finished, lost, t_end

    async def _collect(self, rnd: int, queues: List[List[int]],
                       pending: Set[int], finished: Set[int],
                       lost: Set[int]) -> np.ndarray:
        """Stop still-running workers; per-worker final done counts."""
        done = np.zeros(self.K, dtype=np.int64)
        for k in finished:
            done[k] = len(queues[k])
        for k in sorted(pending - finished - lost):
            try:
                r = await self.proxies[k].rpc({"type": "stop"})
                done[k] = (int(r["done"]) if r.get("round") == rnd
                           else self.proxies[k].last_done)
            except WorkerLost:
                lost.add(k)
        for k in lost:
            done[k] = min(self.proxies[k].last_done, len(queues[k]))
        return done

    # -- execution paths ----------------------------------------------------

    async def run_exchange(self, sched: MasterScheduler) -> EpisodeStats:
        """The stop-flag protocol: MasterScheduler plans, workers run."""
        ledger = {"units_dispatched": 0, "units_completed": 0,
                  "units_reassigned": 0}
        lost_workers: List[int] = []
        rounds_wall = 0.0
        rnd = 0
        t_episode0 = None
        while not sched.finished:
            a = sched.next_assignment()
            if a is None:
                break
            t0 = self.tel.now()
            if t_episode0 is None:
                t_episode0 = t0
            participants, lost = await self._dispatch(rnd, a.queues, ledger)
            finished, lost2, t_end = await self._await_round(
                rnd, a.queues, participants - lost, a.wait_all)
            lost |= lost2
            done = await self._collect(rnd, a.queues,
                                       participants - lost, finished, lost)
            elapsed_wall = max(t_end - t0, 0.0)
            rounds_wall += elapsed_wall
            sched.report(done, elapsed_wall / self.time_scale)
            for k in sorted(lost):
                sched.mark_failed(k)
                lost_workers.append(k)
            ledger["units_completed"] += int(done.sum())
            ledger["units_reassigned"] += int(
                sum(len(a.queues[k]) for k in range(self.K)) - done.sum())
            self.tel.event("round_report", round=rnd,
                           done=[int(d) for d in done],
                           elapsed_model=round(
                               elapsed_wall / self.time_scale, 6))
            rnd += 1
            if rnd > 100_000:
                raise RuntimeError("live exchange failed to converge")
        episode_wall = (self.tel.now() - t_episode0
                        if t_episode0 is not None else 0.0)
        return EpisodeStats(
            t_comp=sched.t_comp, iterations=sched.iterations,
            n_comm=float(sched.n_comm), episode_wall_s=episode_wall,
            rounds_wall_s=rounds_wall, lost_workers=lost_workers,
            ledger=ledger)

    async def run_coded(self, plan: Assignment, N: int) -> EpisodeStats:
        """One-shot redundant run, complete at size-cover >= N."""
        ledger = {"units_dispatched": 0, "units_completed": 0,
                  "units_reassigned": 0}
        sizes = plan.sizes
        t0 = self.tel.now()
        participants, lost = await self._dispatch(0, plan.queues, ledger)
        finished, lost2, t_end = await self._await_round(
            0, plan.queues, participants - lost, wait_all=False,
            cover_target=N, sizes=sizes)
        lost |= lost2
        covered = sum(int(sizes[k]) for k in finished) >= N
        done = await self._collect(0, plan.queues, participants - lost,
                                   finished, lost)
        elapsed_wall = max(t_end - t0, 0.0)
        ledger["units_completed"] += int(done.sum())
        ledger["units_reassigned"] += int(sizes.sum() - done.sum())
        if not covered:
            self.tel.event("cover_incomplete", covered=int(
                sum(int(sizes[k]) for k in finished)), target=N)
        episode_wall = self.tel.now() - t0
        return EpisodeStats(
            t_comp=elapsed_wall / self.time_scale, iterations=1,
            n_comm=float(int(sizes.sum()) - N),
            episode_wall_s=episode_wall, rounds_wall_s=elapsed_wall,
            lost_workers=sorted(lost), ledger=ledger)


# ---------------------------------------------------------------------------
# synchronous entry points
# ---------------------------------------------------------------------------

def live_supported(scheme) -> str:
    """Which live path a scheme instance runs on: ``"exchange"`` (it has
    an executable master protocol) or ``"coded"`` (redundant with the
    size-cover rule).  Raises ``ValueError`` -- at compile time, not
    mid-episode -- for schemes with neither."""
    if getattr(scheme, "live_cover", False):
        return "coded"
    if getattr(scheme, "cover_scheduler", False):
        # the training subsystem's one-shot CoverScheduler takes
        # whole-queue finish-time feedback, which the live round-trip
        # loop cannot provide
        raise ValueError(
            f"scheme {scheme.name!r} cannot run live: its scheduler is a "
            f"one-shot cover protocol (training-only), and it declares "
            f"no live cover rule (live_cover)")
    try:
        scheme.make_scheduler([0], rates=np.ones(1))
        return "exchange"
    except NotImplementedError:
        raise ValueError(
            f"scheme {scheme.name!r} cannot run live: no executable "
            f"master protocol (make_scheduler) and no cover rule "
            f"(live_cover)") from None


def _expected_model_seconds(scheme, het: HetSpec, N: int) -> float:
    """Cheap per-episode duration estimate used only for wall scaling."""
    sizes = np.asarray(scheme.initial_sizes(het, N), dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        per = np.where(sizes > 0, sizes / het.lambdas, 0.0)
    return float(max(per.max(), 1e-9))


async def _episode(scheme, het: HetSpec, N: int, cfg: LiveConfig,
                   time_scale: float, expected_model_s: float,
                   telemetry: Telemetry, seed: int,
                   device: torch.device) -> EpisodeStats:
    if live_supported(scheme) == "exchange":
        sched = scheme.make_scheduler(range(N), rates=het.lambdas)
        plan = None
    else:
        sched = None
        plan = scheme.plan(het, N)
    units = N if plan is None else int(plan.sizes.sum())
    payload = MatmulPayload(units, cfg.unit_rows, cfg.unit_dim, seed=seed,
                            device=device)
    max_q = units if plan is None else int(plan.sizes.max())
    payload.warmup(max_q)           # first-call costs outside the episode
    telemetry.start()
    coord = Coordinator(het, cfg, time_scale, payload, telemetry,
                        seed=seed,
                        expected_wall_s=expected_model_s * time_scale)
    await coord.start()
    try:
        if sched is not None:
            stats = await coord.run_exchange(sched)
        else:
            stats = await coord.run_coded(plan, N)
    finally:
        await coord.shutdown()
    telemetry.close_all()
    stats.ledger["payload_flops"] = int(payload.flops)
    stats.payload_device_ms = payload.device_ms()
    stats.ledger["payload_verified"] = bool(payload.verify())
    return stats


@contextlib.contextmanager
def _collector_paused():
    """Pause the cyclic garbage collector for one episode.  Every
    collection walks the unit-id lists (the scheduler's pool, done ids,
    queues: 1e6 entries each at the paper's scale) while the one event
    loop that runs the coordinator and every worker waits, and the live
    clock charges the wait to ``T_comp``: over two episodes at K 50, N
    1e6 on the host of an NVIDIA H100 80GB HBM3, 700.00 W, 20-44
    collections took 84-210 ms in all (a full one 127.88 ms), and
    ``work_exchange_unknown`` read 14-23% above Monte Carlo against 6-9%
    with the collector paused.  Reference counting still frees what the
    episode drops; its cycles are collected once it is over."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def run_live(scheme_name: str, params: Dict[str, Any], het: HetSpec,
             N: int, cfg: LiveConfig, trials: int,
             seed: int = 0, device=DEFAULT_DEVICE) -> MCReport:
    """``trials`` live episodes of one scheme at one grid point, the
    payload on ``device``."""
    dev = resolve_device(device)
    scheme = get_scheme(scheme_name, **params)
    expected = _expected_model_seconds(scheme, het, N)
    time_scale = cfg.resolve_time_scale(expected)
    ts = np.empty(trials)
    its = np.empty(trials)
    cs = np.empty(trials)
    walls = np.empty(trials)
    coord_walls = np.empty(trials)
    ledger = {"units_dispatched": 0, "units_completed": 0,
              "units_reassigned": 0, "payload_flops": 0}
    lost: List[int] = []
    device_ms: List[float] = []
    tel = Telemetry()
    for t in range(trials):
        tel = Telemetry()
        with _collector_paused():
            stats = asyncio.run(
                _episode(scheme, het, N, cfg, time_scale, expected, tel,
                         seed=seed * 1009 + t, device=dev))
        ts[t], its[t], cs[t] = stats.t_comp, stats.iterations, stats.n_comm
        walls[t] = stats.episode_wall_s
        coord_walls[t] = stats.coordination_wall_s
        for key in ("units_dispatched", "units_completed",
                    "units_reassigned", "payload_flops"):
            ledger[key] += stats.ledger[key]
        lost.extend(stats.lost_workers)
        if stats.payload_device_ms is not None:
            device_ms.append(stats.payload_device_ms)
        if not stats.ledger["payload_verified"]:
            raise RuntimeError(f"live payload verification failed for "
                               f"{scheme_name} trial {t}")
    control = {
        "transport": cfg.transport,
        "time_scale": float(time_scale),
        "expected_model_s": float(expected),
        "measured_t_comp": float(ts.mean()),
        "episode_wall_s": float(walls.mean()),
        "coordination_wall_s": float(coord_walls.mean()),
        "coordination_frac": float(
            coord_walls.mean() / max(walls.mean(), 1e-12)),
        "workers_lost": sorted(set(lost)),
        "ledger": ledger,
        "payload_backend": "torch",
        # mean device ms of an episode's payload calls (None off a card)
        "payload_device_ms": (float(np.mean(device_ms)) if device_ms
                              else None),
        "timeline": tel.to_dict(),     # last episode, representative
    }
    return _report(scheme.name, ts, its, cs,
                   extra={"control_plane": control})


def run_live_grid(scheme_name: str, params: Dict[str, Any],
                  het_specs: Sequence[HetSpec], N: int, cfg: LiveConfig,
                  trials: int, seed: int = 0, rate_schedules=None,
                  device=DEFAULT_DEVICE) -> List[MCReport]:
    """``run_live`` across a scenario grid, one MCReport per spec.

    Live episodes always execute at each grid point's *nominal* rates;
    when the scenario family supplies per-round ``rate_schedules`` the
    reports are stamped ``nominal_rates_only`` (the mc-engine
    convention for schemes that cannot follow a schedule)."""
    dev = resolve_device(device)
    out = []
    for g, het in enumerate(het_specs):
        rep = run_live(scheme_name, params, het, N, cfg, trials,
                       seed=seed + g, device=dev)
        if rate_schedules is not None and rate_schedules[g] is not None:
            rep.extra["nominal_rates_only"] = 1     # mc-engine convention
        out.append(rep)
    return out


__all__ = [
    "Coordinator", "WorkerProxy", "WorkerLost", "EpisodeStats",
    "live_supported", "run_live", "run_live_grid",
]
