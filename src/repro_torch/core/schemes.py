"""Unified ``Scheme`` API of the port: one registry-driven policy surface.

The counterpart of ``repro.core.schemes`` for the paper's six schemes:
``oracle``, ``fixed``, ``uniform``, ``mds`` (L optimized), and work
exchange with known (``work_exchange``) and unknown
(``work_exchange_unknown``) rates.  Each implements

    plan(het, N)                              -> Assignment
    mc(het, N, trials, rng, device="cuda")    -> MCReport
    mc_grid(het_specs, N, trials, rng, ...)   -> [MCReport, ...]

and ``mc_grid_panel`` runs a whole figure panel, with the work-exchange
known/unknown pair fused into one kernel launch.

    >>> rng = np.random.default_rng(0)
    >>> het = HetSpec.uniform_random(50, mu=50.0, sigma2=50**2/6, rng=rng)
    >>> get_scheme("work_exchange").mc(het, N=1_000_000, trials=100, rng=rng)

The host-side numpy draws of ``oracle``, ``fixed``, ``uniform`` stay numpy
exactly as in the reference (their reports are bit-identical to it); MDS
and work exchange draw through the sampler backend on ``device``.  Every
entry point takes ``device=`` (default ``"cuda"``, which raises without a
card; ``"cpu"`` runs the plain PyTorch versions).

Not in this slice (each raises ``NotImplementedError``): the scalar
``simulate`` per-trial path and ``engine="loop"``, ``capped_mode=
"waterfill"`` (both arrive with the exact numpy backend) and
``make_scheduler`` (arrives with the ``MasterScheduler`` port).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from ..device import DEFAULT_DEVICE, resolve_device
from .assignment import proportional_assignment, uniform_assignment
from .exchange import Assignment
from .registry import Registry
from .samplers import (get_backend, get_gamma_rows, resolve_backend,
                       validate_backend)
from .types import ExchangeConfig, HetSpec, RunStats

_LATER_NUMPY = ("arrives with the port's exact numpy backend and scalar "
                "simulate path (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# uniform Monte-Carlo report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MCReport:
    """What every scheme's ``mc`` returns: same shape for all policies.

    Means/stds are over trials.  Per-trial arrays are attached only when
    ``mc(..., keep_trials=True)``.  ``extra`` carries scheme-specific
    derived values (e.g. the optimized MDS ``L``, the ``backend``).
    """

    scheme: str
    trials: int
    t_comp: float               # mean completion time
    t_comp_std: float
    iterations: float           # mean reassignment epochs I
    iterations_std: float
    n_comm: float               # mean extra communication (units, eq. 2)
    n_comm_std: float
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)
    t_comp_trials: Optional[np.ndarray] = None
    iterations_trials: Optional[np.ndarray] = None
    n_comm_trials: Optional[np.ndarray] = None

    def to_dict(self, include_trials: bool = True) -> Dict:
        """JSON-able dict in the reference's results-store record format;
        the per-trial arrays ride along only when attached AND
        ``include_trials``."""
        d = {
            "scheme": self.scheme, "trials": self.trials,
            "t_comp": self.t_comp, "t_comp_std": self.t_comp_std,
            "iterations": self.iterations,
            "iterations_std": self.iterations_std,
            "n_comm": self.n_comm, "n_comm_std": self.n_comm_std,
            "extra": dict(self.extra),
        }
        if include_trials:
            for field in ("t_comp_trials", "iterations_trials",
                          "n_comm_trials"):
                arr = getattr(self, field)
                if arr is not None:
                    d[field] = [float(x) for x in arr]
        return d


def _report(scheme: str, ts: np.ndarray, its: np.ndarray, cs: np.ndarray,
            keep_trials: bool = False,
            extra: Optional[Dict[str, float]] = None) -> MCReport:
    ts, its, cs = (np.asarray(a, dtype=np.float64) for a in (ts, its, cs))
    return MCReport(
        scheme=scheme, trials=int(ts.size),
        t_comp=float(ts.mean()), t_comp_std=float(ts.std()),
        iterations=float(its.mean()), iterations_std=float(its.std()),
        n_comm=float(cs.mean()), n_comm_std=float(cs.std()),
        extra=dict(extra or {}),
        t_comp_trials=ts if keep_trials else None,
        iterations_trials=its if keep_trials else None,
        n_comm_trials=cs if keep_trials else None)


def _grid_reports(scheme_name: str, specs: Sequence[HetSpec], trials: int,
                  arrays, keep_trials: bool, backend_name: str,
                  extra: Optional[Dict[str, float]] = None
                  ) -> List[MCReport]:
    """Slice flat grid-major engine output back into per-spec reports."""
    ts, its, cs = (np.asarray(a).reshape(len(specs), trials) for a in arrays)
    base = {"backend": backend_name, **(extra or {})}
    return [_report(scheme_name, ts[g], its[g], cs[g], keep_trials,
                    extra=dict(base))
            for g in range(len(specs))]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SCHEME_REGISTRY: Registry[Type["Scheme"]] = Registry("scheme",
                                                     dup_label="scheme name")


def register_scheme(name: str, *, aliases: Sequence[str] = ()):
    """Class decorator: key a Scheme subclass under ``name`` (+ aliases)."""
    def deco(cls: Type["Scheme"]) -> Type["Scheme"]:
        SCHEME_REGISTRY.register(name, cls, aliases=aliases)
        cls.name = name
        return cls
    return deco


def get_scheme(name: str, **params) -> "Scheme":
    """Instantiate a registered scheme by canonical name or alias."""
    return SCHEME_REGISTRY.get(name)(**params)


def list_schemes(include_aliases: bool = False) -> List[str]:
    return SCHEME_REGISTRY.names(include_aliases)


# ---------------------------------------------------------------------------
# base class
# ---------------------------------------------------------------------------

class Scheme:
    """Common surface of every scheduling policy.

    Subclasses implement ``initial_sizes`` and ``mc``; ``mc_grid``
    defaults to looping ``mc`` over the specs (drawing from the shared
    ``rng`` in spec order), and schemes with a batched engine override it.
    """

    name: str = "abstract"
    plan_wait_all: bool = True    # static schemes wait for the max
    # schemes whose mc/mc_grid accept a per-exchange-round rate_schedule
    supports_rate_schedule: bool = False

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        raise NotImplementedError

    def plan(self, het: HetSpec, N: int) -> Assignment:
        """Initial id-level queues (contiguous unit ids per worker)."""
        sizes = self.initial_sizes(het, N)
        queues: List[List[int]] = []
        nxt = 0
        for s in sizes:
            queues.append(list(range(nxt, nxt + int(s))))
            nxt += int(s)
        return Assignment(queues=queues, wait_all=self.plan_wait_all)

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        raise NotImplementedError(f"{self.name}.simulate {_LATER_NUMPY}")

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        raise NotImplementedError(
            f"{self.name}.mc as a per-trial simulate loop {_LATER_NUMPY}")

    def mc_grid(self, het_specs: Sequence[HetSpec], N: int, trials: int,
                rng: np.random.Generator, keep_trials: bool = False,
                backend: Optional[str] = None,
                device=DEFAULT_DEVICE) -> List[MCReport]:
        """``mc`` over a scenario grid, one ``MCReport`` per spec."""
        return [self.mc(het, N, trials, rng, keep_trials=keep_trials,
                        backend=backend, device=device)
                for het in het_specs]

    def make_scheduler(self, unit_ids, rates=None, estimator=None,
                       threshold_frac=None):
        raise NotImplementedError(
            f"{self.name}.make_scheduler arrives with the port of "
            f"MasterScheduler (repro.core.exchange) in a later slice")


# ---------------------------------------------------------------------------
# the work-exchange engine through a sampler backend
# ---------------------------------------------------------------------------

def work_exchange_mc_batched(het: HetSpec, N: int, cfg: ExchangeConfig,
                             trials: int, rng: np.random.Generator,
                             keep_trials: bool = False,
                             scheme_name: str = "work_exchange",
                             backend: Optional[str] = None,
                             rate_schedule: Optional[np.ndarray] = None,
                             device=DEFAULT_DEVICE) -> MCReport:
    """All ``trials`` work-exchange runs at once through a sampler
    backend.  ``rate_schedule`` (optional ``(R, K)``) is the per-round
    service-rate schedule of the drifting scenarios."""
    name = resolve_backend(backend)
    dev = resolve_device(device)
    sched = (None if rate_schedule is None
             else np.asarray(rate_schedule, dtype=np.float64)[None, :, :])
    ts, its, cs = get_backend(name).work_exchange_grid(
        het.lambdas[None, :], N, cfg, int(trials), rng,
        rate_schedule=sched, device=dev)
    return _report(scheme_name, ts, its, cs, keep_trials,
                   extra={"backend": name})


# ---------------------------------------------------------------------------
# paper schemes
# ---------------------------------------------------------------------------

@register_scheme("oracle", aliases=("work_conservation",))
class OracleScheme(Scheme):
    """Theorem 1 lower bound: merged process, T ~ Gamma(N, lambda_sum)."""

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        return proportional_assignment(het.lambdas, N)

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        validate_backend(backend)
        resolve_device(device)
        ts = rng.gamma(shape=N, scale=1.0 / het.lambda_sum, size=trials)
        return _report(self.name, ts, np.ones(trials), np.zeros(trials),
                       keep_trials, extra={"exact_mean": N / het.lambda_sum})


class _StaticScheme(Scheme):
    """Assign once (``initial_sizes``) and wait for the max -- no exchange."""

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        validate_backend(backend)
        resolve_device(device)
        assign = self.initial_sizes(het, N)
        busy = assign > 0
        t = rng.gamma(shape=assign[busy], scale=1.0 / het.lambdas[busy],
                      size=(trials, int(busy.sum())))
        return _report(self.name, t.max(axis=1), np.ones(trials),
                       np.zeros(trials), keep_trials)

    def mc_grid(self, het_specs: Sequence[HetSpec], N: int, trials: int,
                rng: np.random.Generator, keep_trials: bool = False,
                backend: Optional[str] = None,
                device=DEFAULT_DEVICE) -> List[MCReport]:
        """One draw for the whole grid: (G * trials, K) Gamma matrix, max
        over busy workers per row.  Same distribution as looped ``mc``."""
        validate_backend(backend)
        resolve_device(device)
        specs = list(het_specs)
        if not specs or len({h.K for h in specs}) != 1:
            return super().mc_grid(specs, N, trials, rng,
                                   keep_trials=keep_trials, backend=backend,
                                   device=device)
        T = int(trials)
        shape = np.repeat(np.stack([self.initial_sizes(h, N)
                                    for h in specs]), T, axis=0)
        scale = np.repeat(np.stack([1.0 / h.lambdas for h in specs]),
                          T, axis=0)
        t = np.zeros(shape.shape)
        busy = shape > 0
        t[busy] = rng.gamma(shape=shape[busy], scale=scale[busy])
        ts = t.max(axis=1).reshape(len(specs), T)
        return [_report(self.name, ts[g], np.ones(T), np.zeros(T),
                        keep_trials, extra={"backend": "numpy"})
                for g in range(len(specs))]


@register_scheme("fixed", aliases=("het_static", "fixed_proportional"))
class FixedScheme(_StaticScheme):
    """Section 5.1: heterogeneity-aware fixed assignment; wait for the max."""

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        return proportional_assignment(het.lambdas, N)


@register_scheme("uniform", aliases=("equal_static",))
class UniformScheme(_StaticScheme):
    """Naive baseline: N/K each, wait for the max (heterogeneity-blind)."""

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        return uniform_assignment(het.K, N)


@register_scheme("mds", aliases=("mds_opt", "mds-opt"))
class MDSScheme(Scheme):
    """Section 3: (K, L) MDS-coded run; T = L-th order statistic of
    Erlang(ceil(N/L), lambda_k).  ``L=None`` optimizes L by Monte Carlo
    (eq. 6) inside ``mc``; ``opt_trials`` bounds that inner sweep.

    All candidate L values become extra rows of ONE ``gamma_rows`` call
    through the sampler backend (the common-random-numbers sweep on the
    ``cuda`` backend), and ``mc_grid`` batches the whole ``specs x L x
    trials`` cube the same way.
    """

    def __init__(self, L: Optional[int] = None, opt_trials: int = 64):
        self.L = L
        self.opt_trials = int(opt_trials)

    def _check_L(self, K: int) -> int:
        if not 1 <= self.L <= K:
            raise ValueError(f"L must be in [1, {K}]; got {self.L}")
        return self.L

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        L = self.L if self.L is not None else het.K
        return np.full(het.K, int(np.ceil(N / L)), dtype=np.int64)

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        name = resolve_backend(backend)
        dev = resolve_device(device)
        if self.L is None:
            # the K-candidate sweep only picks L*: bound its per-candidate
            # budget at opt_trials, then spend the full trial budget on the
            # winner alone (the coupled sweep's samples are correlated
            # across candidates, so the winner's always come from a fresh
            # draw)
            [L] = _mds_select_L_grid([het], N, min(trials, self.opt_trials),
                                     rng, name, dev)
        else:
            L = self._check_L(het.K)
        ts = mds_time_samples(het, N, L, trials, rng, backend=name,
                              device=dev)
        m = int(np.ceil(N / L))
        return _report(self.name, ts, np.ones(trials),
                       np.full(trials, float(m * het.K - N)), keep_trials,
                       extra={"L": L, "backend": name})

    def mc_grid(self, het_specs: Sequence[HetSpec], N: int, trials: int,
                rng: np.random.Generator, keep_trials: bool = False,
                backend: Optional[str] = None,
                device=DEFAULT_DEVICE) -> List[MCReport]:
        """The whole ``specs x candidate-L x trials`` cube in one
        ``gamma_rows`` dispatch (plus one winner top-up dispatch).
        Mixed-K grids fall back to the per-spec loop."""
        specs = list(het_specs)
        if not specs or len({h.K for h in specs}) != 1:
            return super().mc_grid(specs, N, trials, rng,
                                   keep_trials=keep_trials, backend=backend,
                                   device=device)
        name = resolve_backend(backend)
        dev = resolve_device(device)
        K = specs[0].K
        T = int(trials)
        if self.L is not None:
            winners = [self._check_L(K)] * len(specs)
        else:
            winners = _mds_select_L_grid(specs, N, min(T, self.opt_trials),
                                         rng, name, dev)
        sweep_ts = _mds_order_stat_rows(specs, N, winners, T,
                                        get_gamma_rows(name), rng, dev)
        return [self._grid_report(specs[g], N, winners[g], sweep_ts[g], T,
                                  keep_trials, name)
                for g in range(len(specs))]

    def _grid_report(self, het: HetSpec, N: int, L: int, ts: np.ndarray,
                     trials: int, keep_trials: bool, name: str) -> MCReport:
        m = int(np.ceil(N / L))
        return _report(self.name, ts, np.ones(trials),
                       np.full(trials, float(m * het.K - N)), keep_trials,
                       extra={"L": L, "backend": name})


def _mds_select_L_grid(specs: Sequence[HetSpec], N: int, sweep_trials: int,
                       rng: np.random.Generator, name: str, device
                       ) -> List[int]:
    """Pick L* per spec: all candidate L of all specs as grid rows of ONE
    ``gamma_rows`` dispatch -- the common-random-numbers cube of the
    reference's transform backends: per spec ONE shared trial axis,
    candidate Erlangs built as cumulative Gamma increments ``T(m_L) =
    T(m_{L+1}) + Gamma(m_L - m_{L+1})``, ``ceil(sweep_trials / 2)`` trials
    (floor 16).  The samples are correlated across candidates, so callers
    draw the winner's samples afresh.
    """
    if not get_backend(name).coupled_mds_sweep:
        raise NotImplementedError(
            f"the independent MDS L-sweep of exact backends {_LATER_NUMPY}")
    K = specs[0].K
    G = len(specs)
    m = np.array([int(np.ceil(N / L)) for L in range(1, K + 1)],
                 dtype=np.float64)
    inv_lam = np.stack([1.0 / h.lambdas for h in specs])
    ct = max(16, (int(sweep_trials) + 1) // 2)
    m_asc = m[::-1]                          # ascending m: L = K, K-1, ... 1
    diffs = np.empty(K)
    diffs[0] = m_asc[0]
    diffs[1:] = np.diff(m_asc)
    # rows spec-major then increment-major, drawn at unit rate; tied
    # increments (ceil(N/L) ties) draw at shape 1 and are zeroed
    shape_col = np.tile(np.repeat(np.maximum(diffs, 1.0), ct), G)[:, None]
    t = get_gamma_rows(name)(shape_col, np.ones((1, K), dtype=np.float32),
                             rng, device=device)
    t = t.reshape(G, K, ct, K)
    t *= (diffs > 0)[None, :, None, None] * inv_lam[:, None, None, :]
    cube = np.cumsum(t, axis=1)
    cube.sort(axis=3)                        # cube[g, i] = T at m_asc[i]
    winners = []
    for g in range(G):
        best = (1, np.inf)
        for L in range(1, K + 1):
            mean_t = float(cube[g, K - L, :, L - 1].mean())
            if mean_t < best[1]:
                best = (L, mean_t)
        winners.append(best[0])
    return winners


def _mds_order_stat_rows(specs: Sequence[HetSpec], N: int,
                         Ls: Sequence[int], trials: int, draw,
                         rng: np.random.Generator, device
                         ) -> List[np.ndarray]:
    """Per-spec T^MDS(L_g) samples, all specs in one gamma_rows call."""
    K = specs[0].K
    shape_col = np.repeat(
        np.array([float(np.ceil(N / L)) for L in Ls]), trials)[:, None]
    scale_rows = np.repeat(np.stack([1.0 / h.lambdas for h in specs]),
                           trials, axis=0)
    t = draw(shape_col, scale_rows, rng, device=device)
    t.sort(axis=1)
    t = t.reshape(len(specs), trials, K)
    return [t[g, :, Ls[g] - 1] for g in range(len(specs))]


def mds_time_samples(het: HetSpec, N: int, L: int, trials: int,
                     rng: np.random.Generator,
                     backend: Optional[str] = None,
                     device=DEFAULT_DEVICE) -> np.ndarray:
    """Per-trial T^MDS(L): L-th order statistic of the worker Erlangs,
    drawn through the selected sampler backend."""
    name = resolve_backend(backend)
    m = float(np.ceil(N / L))
    shape_rows = np.broadcast_to(np.float64(m), (trials, het.K))
    t = get_gamma_rows(name)(shape_rows, 1.0 / het.lambdas, rng,
                             device=resolve_device(device))
    t.sort(axis=1)
    return t[:, L - 1]


def mds_sweep_batched(het: HetSpec, N: int, trials: int,
                      rng: np.random.Generator,
                      backend: Optional[str] = None,
                      device=DEFAULT_DEVICE
                      ) -> Tuple[int, float, np.ndarray]:
    """Eq. (6) with every candidate L as extra grid rows of ONE batched
    ``gamma_rows`` draw (rows L-major ``(K * trials, K)``).  Returns
    ``(L*, E[T(L*)], samples at L*)``."""
    name = resolve_backend(backend)
    K = het.K
    m = np.array([int(np.ceil(N / L)) for L in range(1, K + 1)],
                 dtype=np.float64)
    shape_rows = np.broadcast_to(np.repeat(m, trials)[:, None],
                                 (K * trials, K))
    t = get_gamma_rows(name)(shape_rows, 1.0 / het.lambdas, rng,
                             device=resolve_device(device))
    t.sort(axis=1)
    best: Tuple[int, float, Optional[np.ndarray]] = (1, np.inf, None)
    for L in range(1, K + 1):
        ts = t[(L - 1) * trials:L * trials, L - 1]
        mean_t = float(ts.mean())
        if mean_t < best[1]:
            best = (L, mean_t, ts)
    return best  # type: ignore[return-value]


class _WorkExchangeBase(Scheme):
    """Shared machinery of the known/unknown work-exchange variants."""

    known: bool = True
    plan_wait_all = False
    supports_rate_schedule = True   # drifting scenarios thread through

    def __init__(self, threshold_frac: float = 0.01,
                 storage_cap_frac: Optional[float] = 1.0,
                 capped_mode: str = "carry",
                 max_iterations: int = 10_000,
                 engine: str = "vectorized"):
        if engine == "loop":
            raise NotImplementedError(f"engine='loop' {_LATER_NUMPY}")
        if engine != "vectorized":
            raise ValueError(f"unknown engine {engine!r}")
        if capped_mode == "waterfill":
            raise NotImplementedError(f"capped_mode='waterfill' "
                                      f"{_LATER_NUMPY}")
        if capped_mode != "carry":
            raise ValueError(f"unknown capped_mode {capped_mode!r}")
        self.threshold_frac = float(threshold_frac)
        self.storage_cap_frac = storage_cap_frac
        self.capped_mode = capped_mode
        self.max_iterations = int(max_iterations)
        self.engine = engine

    def config(self) -> ExchangeConfig:
        return ExchangeConfig(known_heterogeneity=self.known,
                              threshold_frac=self.threshold_frac,
                              storage_cap_frac=self.storage_cap_frac,
                              max_iterations=self.max_iterations)

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        if self.known:
            return proportional_assignment(het.lambdas, N)
        # unknown rates start from the uniform prior (lambda_hat = 1)
        sizes = uniform_assignment(het.K, N)
        if self.storage_cap_frac is not None:
            cap = int(np.ceil(self.storage_cap_frac * N / het.K))
            sizes = np.minimum(sizes, cap)
        return sizes

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           rate_schedule: Optional[np.ndarray] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        return work_exchange_mc_batched(het, N, self.config(), trials, rng,
                                        keep_trials, scheme_name=self.name,
                                        backend=backend,
                                        rate_schedule=rate_schedule,
                                        device=device)

    def mc_grid(self, het_specs: Sequence[HetSpec], N: int, trials: int,
                rng: np.random.Generator, keep_trials: bool = False,
                backend: Optional[str] = None,
                rate_schedule: Optional[np.ndarray] = None,
                device=DEFAULT_DEVICE) -> List[MCReport]:
        """One engine dispatch for the whole ``(het_specs) x trials``
        batch.  Mixed-K grids fall back to the per-spec loop.
        ``rate_schedule`` (optional ``(G, R, K)``) is the drifting-scenario
        contract: service draws follow it, assignments stay nominal /
        estimated."""
        specs = list(het_specs)
        sched = (None if rate_schedule is None
                 else np.asarray(rate_schedule, dtype=np.float64))
        if not specs or len({h.K for h in specs}) != 1:
            return [self.mc(het, N, trials, rng, keep_trials=keep_trials,
                            backend=backend, device=device,
                            rate_schedule=None if sched is None
                            else sched[g])
                    for g, het in enumerate(specs)]
        name = resolve_backend(backend)
        lam = np.stack([h.lambdas for h in specs])
        arrays = get_backend(name).work_exchange_grid(
            lam, N, self.config(), int(trials), rng, rate_schedule=sched,
            device=resolve_device(device))
        return _grid_reports(self.name, specs, int(trials), arrays,
                             keep_trials, name)


@register_scheme("work_exchange", aliases=("work_exchange_known", "we_known"))
class WorkExchangeScheme(_WorkExchangeBase):
    """Algorithm 1: iterative proportional reassignment, rates known."""

    known = True


@register_scheme("work_exchange_unknown",
                 aliases=("we_unknown", "work_exchange_online"))
class WorkExchangeUnknownScheme(_WorkExchangeBase):
    """Algorithm 3: rates estimated online (eq. 23), storage-capped."""

    known = False


# ---------------------------------------------------------------------------
# fused whole-panel dispatch
# ---------------------------------------------------------------------------

def _panel_pair(schemes: Dict[str, Scheme]) -> Optional[Tuple[str, str]]:
    """The fusable known/unknown work-exchange pair of a panel, or None:
    the first known and the first unknown ``_WorkExchangeBase``, sharing
    ``threshold_frac`` and ``max_iterations`` (the fused launch runs one
    round loop for both)."""
    known_key = unknown_key = None
    for key, sch in schemes.items():
        if not isinstance(sch, _WorkExchangeBase):
            continue
        if sch.known and known_key is None:
            known_key = key
        elif not sch.known and unknown_key is None:
            unknown_key = key
    if known_key is None or unknown_key is None:
        return None
    k, u = schemes[known_key], schemes[unknown_key]
    if (k.threshold_frac != u.threshold_frac
            or k.max_iterations != u.max_iterations):
        return None
    return known_key, unknown_key


def mc_grid_panel(schemes: Dict[str, Scheme], het_specs: Sequence[HetSpec],
                  N: int, trials: int, rng, keep_trials: bool = False,
                  backend: Optional[str] = None,
                  rate_schedule: Optional[np.ndarray] = None,
                  device=DEFAULT_DEVICE) -> Dict[str, List[MCReport]]:
    """A whole figure panel -- ordered ``report_key -> Scheme`` -- over the
    scenario grid, with the work-exchange known/unknown pair fused into
    ONE kernel launch (known rows stacked on unknown rows with a per-row
    flag).  Everything else runs its own ``mc_grid``.

    ``rng`` is either one Generator (each scheme gets a child stream
    derived in input order, as in the reference) or a ``key -> Generator``
    mapping.  Fused reports carry ``extra["fused_panel"] = 1``.
    """
    specs = list(het_specs)
    name = resolve_backend(backend)
    dev = resolve_device(device)
    panel_fn = get_backend(name).work_exchange_panel
    if isinstance(rng, dict):
        child = dict(rng)
        missing = [k for k in schemes if k not in child]
        if missing:
            raise ValueError(f"rng mapping is missing streams for {missing}")
    else:
        child = {key: np.random.default_rng(rng.integers(0, 2**63))
                 for key in schemes}
    pair = (_panel_pair(schemes)
            if specs and len({h.K for h in specs}) == 1 else None)
    sched = (None if rate_schedule is None
             else np.asarray(rate_schedule, dtype=np.float64))
    fused: Dict[str, List[MCReport]] = {}
    if pair is not None:
        kk, uk = pair
        lam = np.stack([h.lambdas for h in specs])
        res = panel_fn(lam, N, schemes[kk].config(), schemes[uk].config(),
                       int(trials), child[kk], rate_schedule=sched,
                       device=dev)
        for key, slot in ((kk, "known"), (uk, "unknown")):
            fused[key] = _grid_reports(schemes[key].name, specs,
                                       int(trials), res[slot], keep_trials,
                                       name, extra={"fused_panel": 1})
    out: Dict[str, List[MCReport]] = {}
    for key, sch in schemes.items():
        if key in fused:
            out[key] = fused[key]
            continue
        kwargs = {}
        if sched is not None and sch.supports_rate_schedule:
            kwargs["rate_schedule"] = sched
        out[key] = sch.mc_grid(specs, N, int(trials), child[key],
                               keep_trials=keep_trials, backend=name,
                               device=dev, **kwargs)
    return out


__all__ = [
    "MCReport", "Scheme", "SCHEME_REGISTRY", "register_scheme",
    "get_scheme", "list_schemes", "OracleScheme", "FixedScheme",
    "UniformScheme", "MDSScheme", "WorkExchangeScheme",
    "WorkExchangeUnknownScheme", "work_exchange_mc_batched",
    "mds_time_samples", "mds_sweep_batched", "mc_grid_panel",
]
