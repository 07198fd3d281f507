"""CLI for the declarative experiment API (the port of
``python -m repro.experiments``).

    # run a spec file end-to-end through the store, on the card
    python -m repro_torch.experiments path/to/spec.json

    # built-in demo specs; --device cpu runs the plain PyTorch versions of
    # the kernels (the default, cuda, raises without a card)
    python -m repro_torch.experiments --demo quick --device cpu
    python -m repro_torch.experiments --demo drifting
    python -m repro_torch.experiments --demo trace
    python -m repro_torch.experiments --demo hcmm
    python -m repro_torch.experiments --demo train

    # streaming arrivals: the schemes as dispatch policies, swept over
    # offered load on the torch slot-step engine (on the card by default)
    python -m repro_torch.experiments --demo serving
    python -m repro_torch.experiments --demo serving-trace --device cpu

    # prove the cache: second run must be a content-address hit
    python -m repro_torch.experiments --demo quick --check-cache

    # the fluid engine as torch ops, its rows split over every card
    python -m repro_torch.experiments --demo quick --backend torch \
        --devices auto

    # the schemes EXECUTED through the live control plane (asyncio
    # coordinator, workers, transports; the matmul payload on the device)
    python -m repro_torch.experiments --demo live
    python -m repro_torch.experiments --demo live-fault --device cpu
    python -m repro_torch.experiments --demo quick --live

    # query the store: one line per entry (hash, name, family, schemes,
    # backend, devices, wall)
    python -m repro_torch.experiments ls

    # compare two stored results: per-scheme T_comp deltas in combined
    # standard errors (hash prefixes resolve when unambiguous)
    python -m repro_torch.experiments compare 825d75a6 07eaead1

Exit codes: 0 ok, 1 bad spec / path not ported / failed --check-cache /
unknown hash.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..control import LiveConfig
from ..device import DEFAULT_DEVICE
from ..scenarios import DriftingScenario, ExplicitScenario, HCMMSweepScenario
from ..scenarios.traces import DEFAULT_CORPUS, TraceCorpusScenario
from ..serving import ServingConfig

from .engine import ExperimentResult, run_experiment
from .spec import ExperimentSpec, ScenarioGrid, scheme_spec
from .store import ResultsStore, default_store

DEMOS = ("quick", "drifting", "trace", "hcmm", "serving", "serving-trace",
         "live", "live-fault", "train")


def demo_spec(kind: str) -> ExperimentSpec:
    if kind == "quick":
        return ExperimentSpec(
            name="demo-quick",
            grid=ScenarioGrid(K=16, points=[(mu, mu * mu / 6, int(mu))
                                            for mu in (10.0, 30.0)]),
            schemes=(scheme_spec("work_exchange"),
                     scheme_spec("work_exchange_unknown"),
                     scheme_spec("hedged"),
                     scheme_spec("mds", opt_trials=16)),
            N=20_000, trials=64, seed=1234)
    if kind == "drifting":
        # rates move underneath the online estimator: the claim the
        # drifting family exists to stress
        return ExperimentSpec(
            name="demo-drifting",
            grid=DriftingScenario(K=16,
                                  points=[(20.0, 20.0 ** 2 / 6, 1),
                                          (50.0, 50.0 ** 2 / 6, 2)],
                                  kind="ar1", rounds=24),
            schemes=(scheme_spec("work_exchange"),
                     scheme_spec("work_exchange_unknown"),
                     scheme_spec("hedged")),
            N=20_000, trials=64, seed=1234)
    if kind == "trace":
        grid = TraceCorpusScenario(corpus=DEFAULT_CORPUS, K=16,
                                   windows=((0, 0), (24, 16)), epochs=12)
        return ExperimentSpec(
            name="demo-trace",
            grid=grid,
            schemes=(scheme_spec("work_exchange"),
                     scheme_spec("work_exchange_unknown"),
                     # replay window 0's exact trace through the
                     # id-aware master protocol
                     scheme_spec("trace_replay", key="trace_replay@w0",
                                 **grid.trace_replay_params(0))),
            N=8_000, trials=8, seed=1234)
    if kind == "serving":
        # streaming arrivals: the same schemes as dispatch policies,
        # swept over offered load, on the torch engine
        return ExperimentSpec(
            name="demo-serving",
            grid=ScenarioGrid(K=8, points=[(20.0, 20.0 ** 2 / 6, 5)]),
            schemes=(scheme_spec("work_exchange"),
                     scheme_spec("fixed"),
                     scheme_spec("het_mds")),
            N=100, trials=8, seed=1234,
            serving=ServingConfig(loads=(0.6, 0.9), slots=600,
                                  deadline_slo=4.0, backend="torch"))
    if kind == "serving-trace":
        # measured rates AND measured demand: the trace corpus drives
        # both the per-slot service rates (scenario schedule) and the
        # arrival intensity (trace arrival process)
        grid = TraceCorpusScenario(corpus=DEFAULT_CORPUS, K=16,
                                   windows=((0, 0),), epochs=12)
        return ExperimentSpec(
            name="demo-serving-trace",
            grid=grid,
            schemes=(scheme_spec("work_exchange"),
                     scheme_spec("work_exchange_unknown")),
            N=100, trials=8, seed=1234,
            serving=ServingConfig(loads=(0.7,), arrival="trace",
                                  arrival_params={"epochs": 12},
                                  slots=600, backend="torch"))
    if kind == "live":
        # the same schemes EXECUTED through the asyncio control plane:
        # real transport messages, real matmul shards, measured T_comp
        # (mds pins L so ceil(N/m) == L and the live size-cover rule
        # equals the L-th order statistic)
        return ExperimentSpec(
            name="demo-live",
            grid=ScenarioGrid(K=4, points=[(4.0, 4.0 ** 2 / 6, 4)]),
            schemes=(scheme_spec("work_exchange"),
                     scheme_spec("work_exchange_unknown"),
                     scheme_spec("fixed"),
                     scheme_spec("mds", L=3),
                     scheme_spec("hedged")),
            N=2_000, trials=4, seed=1234,
            execution="live", live=LiveConfig(target_wall_s=0.5))
    if kind == "live-fault":
        # kill worker 0 a quarter of the way in: the episode must
        # complete degraded (leftovers reassigned), not hang
        return ExperimentSpec(
            name="demo-live-fault",
            grid=ScenarioGrid(K=4, points=[(4.0, 4.0 ** 2 / 6, 4)]),
            schemes=(scheme_spec("work_exchange"),),
            N=2_000, trials=2, seed=1234,
            execution="live",
            live=LiveConfig(target_wall_s=0.5, timeout_s=0.1, retries=1,
                            kill_worker=0, kill_after_frac=0.25))
    if kind == "train":
        # every scheme as an epoch-assignment policy over real
        # gradients: one shared trajectory (bit-identical loss curves),
        # per-policy virtual wall-clock
        from ..hettrain import TrainConfig
        return ExperimentSpec(
            name="demo-train",
            grid=ScenarioGrid(K=4, points=[(4.0, 4.0 ** 2 / 6, 11)]),
            schemes=(scheme_spec("work_exchange"),
                     scheme_spec("work_exchange_unknown"),
                     scheme_spec("uniform"),
                     scheme_spec("fixed"),
                     scheme_spec("gradient_coded")),
            N=16, trials=3, seed=1234,
            training=TrainConfig(steps=6))
    raise SystemExit(f"unknown demo {kind!r}; have: {', '.join(DEMOS)}")


def hcmm_demo_specs():
    """The hcmm sweep as one experiment PER operating point: the axis
    of the family is per-worker load, so each point must run at its own
    ``point_N(g)`` -- the N its redundancy was optimized for.  (A single
    ExperimentSpec carries one N, which would flatten the load axis.)
    """
    grid = HCMMSweepScenario(K=16, mu=30.0, sigma2=30.0 ** 2 / 6,
                             seed=3, loads=(4, 32, 256), opt_trials=96)
    specs = []
    for g, (het, n_g, r_star) in enumerate(grid.operating_points()):
        specs.append(ExperimentSpec(
            name=f"demo-hcmm-load{grid.loads[g]}",
            grid=ExplicitScenario(explicit=(het,)),
            schemes=(scheme_spec("fixed"),
                     scheme_spec("work_exchange"),
                     scheme_spec("het_mds", key=f"het_mds@r{r_star:g}",
                                 redundancy=r_star)),
            N=n_g, trials=256, seed=1234))
    return specs


def show(result: ExperimentResult, store: ResultsStore) -> None:
    spec = result.spec
    status = "cache HIT" if result.cache_hit else "computed"
    print(f"experiment {spec.name!r}: backend={spec.backend} "
          f"devices={spec.devices} N={spec.N} trials={spec.trials} "
          f"grid={len(spec.grid)} points ({spec.grid.family})")
    print(f"  spec hash {result.spec_hash}")
    print(f"  {status} in {result.wall_s:.3f}s -> "
          f"{store.path_for(result.spec_hash)}")
    for key, rows in result.reports.items():
        for g, rep in enumerate(rows):
            if rep.extra.get("serving"):
                # serving rows: the latency surface, not batch T_comp
                slo = (f" slo_miss={rep.extra['slo_miss_rate']:.3f}"
                       if "slo_miss_rate" in rep.extra else "")
                if rep.extra.get("latency_censored"):
                    # zero completions: percentiles are horizon bounds
                    slo += "  [CENSORED: latency >= horizon]"
                elif rep.extra.get("censored_frac"):
                    slo += (f"  [censored_frac="
                            f"{rep.extra['censored_frac']:.2f}]")
                print(f"  {key:24s} pt {rep.extra.get('grid_point', 0):g} "
                      f"load {rep.extra['offered_load']:g}: "
                      f"sojourn={rep.t_comp:8.4f} "
                      f"p50={rep.extra['p50']:.4f} "
                      f"p99={rep.extra['p99']:.4f} "
                      f"thru={rep.extra['throughput_jobs']:.2f}/s "
                      f"reject={rep.extra['reject_rate']:.3f}{slo}")
                continue
            tr = rep.extra.get("training")
            if tr:
                tgt = ("" if "wall_to_target" not in tr else
                       (f" wall_to_target={tr['wall_to_target']:.3f}"
                        f"@{tr['steps_to_target']} steps"
                        if tr["steps_to_target"] > 0
                        else " target NOT reached"))
                nom = (" [nominal rates]"
                       if rep.extra.get("nominal_rates_only") else "")
                print(f"  {key:24s} point {g}: wall={rep.t_comp:10.4f} "
                      f"+- {rep.t_comp_std:8.4f}  "
                      f"loss {tr['loss_curve'][0]:.4f}->"
                      f"{tr['final_loss']:.4f} in {tr['steps']} steps  "
                      f"wait={tr['straggler_wait_frac']:.1%}"
                      f"{tgt}{nom}")
                continue
            cp = rep.extra.get("control_plane")
            if cp:
                lost = (f" lost={cp['workers_lost']}"
                        if cp["workers_lost"] else "")
                print(f"  {key:24s} point {g}: T_comp={rep.t_comp:10.4f} "
                      f"+- {rep.t_comp_std:8.4f}  I={rep.iterations:6.2f}  "
                      f"N_comm={rep.n_comm:10.1f}  "
                      f"live[{cp['transport']}] "
                      f"wall={cp['episode_wall_s']:.3f}s "
                      f"coord={cp['coordination_frac']:.1%}{lost}")
                continue
            extra = "".join(f" {k}={v:g}" for k, v in rep.extra.items()
                            if isinstance(v, (int, float)))
            print(f"  {key:24s} point {g}: T_comp={rep.t_comp:10.4f} "
                  f"+- {rep.t_comp_std:8.4f}  I={rep.iterations:6.2f}  "
                  f"N_comm={rep.n_comm:10.1f}{extra}")


# ---------------------------------------------------------------------------
# store query commands (ls / compare)
# ---------------------------------------------------------------------------

def _store_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--store", default=None,
                    help="store root (default results/store)")


def _open_store(args) -> ResultsStore:
    return ResultsStore(args.store) if args.store else default_store()


def _resolve_hash(store: ResultsStore, prefix: str) -> str:
    """Resolve a (possibly shortened) spec hash against the store."""
    matches = [h for h in store.entries() if h.startswith(prefix)]
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise SystemExit(f"no store entry matches {prefix!r} under "
                         f"{store.root} ({len(store.entries())} entries; "
                         f"try 'ls')")
    raise SystemExit(f"ambiguous hash prefix {prefix!r}: "
                     f"{[m[:16] for m in matches]}")


def cmd_ls(argv) -> int:
    """One line per store entry: the spec's identity at a glance."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments ls",
                                 description="list results-store entries")
    _store_arg(ap)
    args = ap.parse_args(argv)
    store = _open_store(args)
    entries = store.entries()
    if not entries:
        print(f"(no entries under {store.root})")
        return 0
    print(f"{'hash':16s}  {'name':14s} {'family':14s} {'grid':>4s} "
          f"{'schemes':28s} {'backend':7s} {'dev':>3s} {'N':>9s} "
          f"{'trials':>6s} {'wall_s':>8s}")
    for h in entries:
        result = store.get(h)
        if result is None:
            print(f"{h[:16]}  (unreadable or mismatched entry)")
            continue
        spec = result.spec
        keys = list(result.reports)
        shown = ",".join(keys[:3]) + ("..." if len(keys) > 3 else "")
        print(f"{h[:16]}  {spec.name:14s} {spec.grid.family:14s} "
              f"{len(spec.grid):4d} {shown:28s} {str(spec.backend):7s} "
              f"{spec.devices!s:>3s} {spec.N:9d} {spec.trials:6d} "
              f"{result.wall_s:8.3f}")
        if spec.serving is not None:
            # serving entries: per-scheme p99 at the heaviest swept load
            top = max(spec.serving.loads)
            parts = []
            for key, rows in result.reports.items():
                vals = [r.extra["p99"] for r in rows
                        if "p99" in r.extra
                        and r.extra.get("offered_load") == top]
                if vals:
                    parts.append(f"{key}={sum(vals) / len(vals):.3g}")
            if parts:
                print(f"{'':18s}serving p99@load={top:g}: "
                      + "  ".join(parts))
        if spec.training is not None:
            # training entries: per-scheme final loss (identical across
            # schemes by work conservation) and mean total wall
            parts = [f"{key}={rows[0].t_comp:.3g}"
                     for key, rows in result.reports.items() if rows]
            fl = next((rows[0].extra["training"]["final_loss"]
                       for rows in result.reports.values()
                       if rows and "training" in rows[0].extra), None)
            if parts:
                tail = "" if fl is None else f"  final_loss={fl:.4f}"
                print(f"{'':18s}train wall: " + "  ".join(parts) + tail)
    return 0


def cmd_compare(argv) -> int:
    """Per-scheme T_comp deltas between two stored results, in combined
    standard errors -- the store-native answer to "did this change
    matter at Monte-Carlo tolerance?"."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments compare",
        description="compare two stored results (T_comp deltas in SE "
                    "units)")
    ap.add_argument("hash_a")
    ap.add_argument("hash_b")
    _store_arg(ap)
    args = ap.parse_args(argv)
    store = _open_store(args)
    results = {}
    for tag, prefix in (("a", args.hash_a), ("b", args.hash_b)):
        h = _resolve_hash(store, prefix)
        results[tag] = store.get(h)
        if results[tag] is None:
            raise SystemExit(f"entry {h[:16]} is unreadable or mismatched")
    a, b = results["a"], results["b"]
    print(f"a: {a.spec_hash[:16]}  {a.spec.name!r} "
          f"({a.spec.grid.family}, {len(a.spec.grid)} points, "
          f"N={a.spec.N}, trials={a.spec.trials}, {a.spec.backend})")
    print(f"b: {b.spec_hash[:16]}  {b.spec.name!r} "
          f"({b.spec.grid.family}, {len(b.spec.grid)} points, "
          f"N={b.spec.N}, trials={b.spec.trials}, {b.spec.backend})")
    shared = [k for k in a.reports if k in b.reports]
    for only, r in (("a", a), ("b", b)):
        extra = [k for k in r.reports if k not in shared]
        if extra:
            print(f"  (only in {only}: {', '.join(extra)})")
    if not shared:
        print("no shared scheme keys -- nothing to compare")
        return 0
    print(f"  {'scheme':24s} {'pt':>3s} {'T_comp a':>12s} {'T_comp b':>12s}"
          f" {'delta':>12s} {'delta/SE':>9s}")
    worst = 0.0
    zero_se_diffs = 0
    for key in shared:
        rows_a, rows_b = a.report(key), b.report(key)
        for g, (ra, rb) in enumerate(zip(rows_a, rows_b)):
            se = float(np.hypot(ra.t_comp_std / np.sqrt(max(ra.trials, 1)),
                                rb.t_comp_std / np.sqrt(max(rb.trials, 1))))
            delta = rb.t_comp - ra.t_comp
            if se > 0:
                in_se = abs(delta) / se
                worst = max(worst, in_se)
                label = f"{in_se:9.1f}"
                mark = "" if in_se < 6 else "  <-- >6 SE"
            elif delta == 0:
                label = f"{'exact':>9s}"
                mark = ""
            else:       # differing numbers with no spread to judge by
                zero_se_diffs += 1
                label = f"{'0-SE':>9s}"
                mark = "  <-- differs, no SE (trials too small)"
            print(f"  {key:24s} {g:3d} {ra.t_comp:12.4f} {rb.t_comp:12.4f}"
                  f" {delta:+12.4f} {label}{mark}")
            if ra.extra.get("serving") and rb.extra.get("serving"):
                # serving rows carry a latency surface: surface the
                # percentile / SLO deltas instead of dropping them
                cens = ("" if not (ra.extra.get("latency_censored")
                                   or rb.extra.get("latency_censored"))
                        else "  [censored: horizon bound, not measured]")
                for field in ("p50", "p99", "slo_miss_rate"):
                    if field in ra.extra and field in rb.extra:
                        va, vb = ra.extra[field], rb.extra[field]
                        print(f"    {field:>22s} {va:12.4f} {vb:12.4f}"
                              f" {vb - va:+12.4f}{cens}")
                        cens = ""
        if len(rows_a) != len(rows_b):
            print(f"  {key:24s} (grids differ: {len(rows_a)} vs "
                  f"{len(rows_b)} points; compared the overlap)")
    verdict = "within" if worst < 6 else "BEYOND"
    tail = (f"; {zero_se_diffs} row(s) differ with zero combined SE -- "
            f"no MC verdict possible for them" if zero_se_diffs else "")
    print(f"max |delta| = {worst:.1f} combined SE "
          f"({verdict} the 6-SE MC band{tail})")
    return 0


def _run(argv) -> int:
    if argv and argv[0] == "ls":
        return cmd_ls(argv[1:])
    if argv and argv[0] == "compare":
        return cmd_compare(argv[1:])

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments",
        description="run a declarative experiment spec through the "
                    "content-addressed results store (subcommands: ls, "
                    "compare)")
    ap.add_argument("spec", nargs="?", help="path to an ExperimentSpec "
                                            "JSON file")
    ap.add_argument("--demo", help=f"built-in demo spec "
                                   f"({', '.join(DEMOS)})")
    ap.add_argument("--backend", help="override the sampler backend")
    ap.add_argument("--devices", help="override the device count (int or "
                                      "'auto'); torch and cuda split their "
                                      "rows over that many cards")
    ap.add_argument("--trials", type=int, help="override the trial budget")
    ap.add_argument("--n", type=int, help="override N (work units)")
    ap.add_argument("--live", action="store_true",
                    help="execute the spec through the live control "
                         "plane (execution='live' with default "
                         "LiveConfig) instead of Monte Carlo")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to run on (default cuda; cpu runs "
                         "the plain PyTorch versions of the kernels)")
    _store_arg(ap)
    ap.add_argument("--force", action="store_true",
                    help="recompute even on a store hit")
    ap.add_argument("--check-cache", action="store_true",
                    help="run twice; fail unless the second run is a "
                         "content-address hit")
    args = ap.parse_args(argv)

    if bool(args.spec) == bool(args.demo):
        ap.error("give exactly one of: a spec file, or --demo")
    if args.spec:
        specs = [ExperimentSpec.from_json(Path(args.spec).read_text())]
    elif args.demo == "hcmm":
        specs = hcmm_demo_specs()      # one experiment per load point
    else:
        specs = [demo_spec(args.demo)]

    overrides = {}
    if args.backend:
        overrides["backend"] = args.backend
    if args.devices:
        overrides["devices"] = (args.devices if args.devices == "auto"
                                else int(args.devices))
    if args.trials:
        overrides["trials"] = args.trials
    if args.n:
        overrides["N"] = args.n
    if args.live:
        # same spec, live execution (post-init fills the default
        # LiveConfig); a different spec_hash, so MC and live runs of
        # one study sit side by side in the store for `compare`
        overrides["execution"] = "live"
    if overrides:
        specs = [spec.replace(**overrides) for spec in specs]

    store = _open_store(args)
    for spec in specs:
        result = run_experiment(spec, store=store, force=args.force,
                                device=args.device)
        show(result, store)

        if args.check_cache:
            again = run_experiment(spec, store=store, device=args.device)
            if not again.cache_hit:
                print("check-cache: FAILED -- second run was not a store "
                      "hit", file=sys.stderr)
                return 1
            if again.to_dict()["reports"] != result.to_dict()["reports"]:
                print("check-cache: FAILED -- stored reports differ from "
                      "the computed run", file=sys.stderr)
                return 1
            print("check-cache: OK (second run was a content-address hit "
                  "with identical reports)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return _run(argv)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
