"""Unified ``Scheme`` API of the port: one registry-driven policy surface.

The counterpart of ``repro.core.schemes`` for the paper's six schemes --
``oracle``, ``fixed``, ``uniform``, ``mds`` (L optimized), and work
exchange with known (``work_exchange``) and unknown
(``work_exchange_unknown``) rates -- and the reference's four others.
Each implements

    plan(het, N)                              -> Assignment
    simulate(het, N, rng)                     -> RunStats  (one exact trial)
    mc(het, N, trials, rng, device="cuda")    -> MCReport
    mc_grid(het_specs, N, trials, rng, ...)   -> [MCReport, ...]
    make_scheduler(unit_ids, rates, ...)      -> the executable master

and ``mc_grid_panel`` runs a whole figure panel, with the work-exchange
known/unknown pair fused into one kernel launch on the ``cuda`` backend.

    >>> rng = np.random.default_rng(0)
    >>> het = HetSpec.uniform_random(50, mu=50.0, sigma2=50**2/6, rng=rng)
    >>> get_scheme("work_exchange").mc(het, N=1_000_000, trials=100, rng=rng)

``simulate`` is the scalar single-trial reference (host numpy, no
device), and ``engine="loop"`` runs ``mc`` as a loop of it.  The
host-side numpy draws of ``oracle``, ``fixed``, ``uniform`` and the
per-trial loops are copied from the reference line for line, so their
reports are bit-identical to it; MDS and work exchange draw through the
sampler backend (``cuda`` by default, ``torch`` for the fluid engine as
torch ops, ``numpy`` for the exact engine).
Every ``mc`` entry point takes ``device=`` (default ``"cuda"``, which
raises without a card; ``"cpu"`` runs the plain PyTorch versions).

Beside the paper's schemes stand the reference's three scenario schemes:
``het_mds`` (heterogeneous coded loads, alias ``hcmm``), ``trace_replay``
(measured per-epoch rates through the master protocol) and ``hedged``
(the fastest worker mirrors the straggler's queue).  They draw with numpy
on the host, as the reference's do, so their reports are the reference's
bit for bit at any backend.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Literal, Optional, Sequence, Tuple, Type

import numpy as np

from ..device import DEFAULT_DEVICE, resolve_device
from .assignment import (capped_proportional_assignment,
                         largest_remainder_round, proportional_assignment,
                         uniform_assignment)
from .exchange import Assignment, CoverScheduler, MasterScheduler
from .registry import Registry
from .samplers import (get_backend, get_gamma_rows, resolve_backend,
                       validate_backend)
from .types import ExchangeConfig, HetSpec, RunStats


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

    # legacy ExchangeMC field names (the deprecated ``simulator`` shim)
    @property
    def t_std(self) -> float:
        return self.t_comp_std

    @property
    def i_std(self) -> float:
        return self.iterations_std

    @property
    def c_std(self) -> float:
        return self.n_comm_std

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

    @classmethod
    def from_dict(cls, d: Dict) -> "MCReport":
        """The inverse of ``to_dict`` (what a results store reads back)."""
        trials = {field: (np.asarray(d[field], dtype=np.float64)
                          if d.get(field) is not None else None)
                  for field in ("t_comp_trials", "iterations_trials",
                                "n_comm_trials")}
        return cls(scheme=d["scheme"], trials=int(d["trials"]),
                   t_comp=float(d["t_comp"]),
                   t_comp_std=float(d["t_comp_std"]),
                   iterations=float(d["iterations"]),
                   iterations_std=float(d["iterations_std"]),
                   n_comm=float(d["n_comm"]),
                   n_comm_std=float(d["n_comm_std"]),
                   extra=dict(d.get("extra", {})), **trials)


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

    Subclasses implement ``initial_sizes`` + ``simulate`` and may override
    ``mc`` with a trial-vectorized engine; the default ``mc`` loops
    ``simulate``.  ``redundant`` marks schemes that ship more than N units
    (coded redundancy), where exact unit-level conservation does not apply.
    """

    name: str = "abstract"
    redundant: bool = False
    plan_wait_all: bool = True    # static schemes wait for the max
    # redundant schemes whose live execution (repro_torch.control)
    # completes at the size-cover instant: finished workers' assigned
    # sizes >= N
    live_cover: bool = False
    # schemes whose mc/mc_grid accept a per-exchange-round rate_schedule
    supports_rate_schedule: bool = False

    # -- planning -----------------------------------------------------------

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

    # -- simulation ---------------------------------------------------------

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        raise NotImplementedError

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        """Monte-Carlo report over ``trials`` runs of ``simulate``.

        The per-trial loop draws with numpy on the host, but still
        validates ``backend`` (a typo'd name raises the registry's
        ``KeyError``) and resolves ``device``, as every ``mc`` does.
        """
        validate_backend(backend)
        resolve_device(device)
        ts = np.empty(trials)
        its = np.empty(trials)
        cs = np.empty(trials)
        for i in range(trials):
            s = self.simulate(het, N, rng)
            ts[i], its[i], cs[i] = s.t_comp, s.iterations, s.n_comm
        return _report(self.name, ts, its, cs, keep_trials)

    def mc_grid(self, het_specs: Sequence[HetSpec], N: int, trials: int,
                rng: np.random.Generator, keep_trials: bool = False,
                backend: Optional[str] = None,
                device=DEFAULT_DEVICE) -> List[MCReport]:
        """``mc`` over a scenario grid, one ``MCReport`` per spec (drawing
        from the shared ``rng`` in spec order); schemes with a batched
        engine override it."""
        return [self.mc(het, N, trials, rng, keep_trials=keep_trials,
                        backend=backend, device=device)
                for het in het_specs]

    # -- executable protocol (training runtimes) -----------------------------

    def make_scheduler(self, unit_ids: Sequence[int],
                       rates: Optional[np.ndarray] = None,
                       estimator=None,
                       threshold_frac: Optional[float] = None
                       ) -> MasterScheduler:
        raise NotImplementedError(
            f"scheme {self.name!r} has no executable master protocol")


# ---------------------------------------------------------------------------
# scalar single-trial primitives (the reference path)
# ---------------------------------------------------------------------------

def _iteration_outcome(assign: np.ndarray, lambdas: np.ndarray,
                       rng: np.random.Generator):
    """One work-exchange iteration: returns (t_star, done) exactly.

    Poisson-process conditioning: given worker k's n_k-th arrival at T_k,
    the earlier n_k - 1 epochs are uniform order statistics on (0, T_k), so
    N_done | T_k ~ Binomial(n_k - 1, T*/T_k) for non-finishing workers.
    """
    K = assign.size
    t_k = np.full(K, np.inf)
    busy = assign > 0
    t_k[busy] = rng.gamma(shape=assign[busy], scale=1.0 / lambdas[busy])
    finisher = int(np.argmin(t_k))
    t_star = float(t_k[finisher])
    done = np.zeros(K, dtype=np.int64)
    done[finisher] = assign[finisher]
    others = busy.copy()
    others[finisher] = False
    if others.any():
        n = assign[others] - 1
        p = np.clip(t_star / t_k[others], 0.0, 1.0)
        done[others] = rng.binomial(np.maximum(n, 0), p)
    return t_star, done


def _final_phase(assign: np.ndarray, lambdas: np.ndarray,
                 rng: np.random.Generator) -> float:
    """Below the cutting threshold: assign and wait for ALL workers (max)."""
    busy = assign > 0
    if not busy.any():
        return 0.0
    t_k = rng.gamma(shape=assign[busy], scale=1.0 / lambdas[busy])
    return float(t_k.max())


def simulate_work_exchange_scalar(het: HetSpec, N: int, cfg: ExchangeConfig,
                                  rng: np.random.Generator,
                                  capped_mode: Literal["carry", "waterfill"]
                                  = "carry",
                                  rate_schedule: Optional[np.ndarray] = None
                                  ) -> RunStats:
    """Algorithms 1 (known het) and 3 (unknown het), single trial.

    ``rate_schedule`` (optional ``(R, K)``) drives drifting scenarios:
    round ``r``'s service draws use row ``min(r, R - 1)`` while the
    assignment keeps using the nominal ``het.lambdas`` (known) or the
    online estimate (unknown) -- the exact per-trial reference the
    batched engines are validated against.
    """
    lam = het.lambdas
    K = het.K
    sched = None
    if rate_schedule is not None:
        sched = np.asarray(rate_schedule, dtype=np.float64)
        if sched.ndim != 2 or sched.shape[1] != K:
            raise ValueError(f"rate_schedule must be (R, K={K}); "
                             f"got shape {sched.shape}")
    threshold = cfg.threshold_frac * N / K
    cap = (np.inf if cfg.storage_cap_frac is None or cfg.known_heterogeneity
           else int(np.ceil(cfg.storage_cap_frac * N / K)))

    # estimator state (paper eq. 23)
    est_done = np.zeros(K, dtype=np.float64)
    est_time = 0.0
    lam_hat = np.ones(K, dtype=np.float64)

    n_rem = N                       # unassigned + leftover units
    n_left_prev = np.zeros(K, dtype=np.int64)   # leftover held by workers
    n_done = np.zeros(K, dtype=np.int64)
    t_comp = 0.0
    n_comm = 0.0
    iters = 0
    t_iter = []

    while n_rem > threshold and iters < cfg.max_iterations:
        rates = lam if cfg.known_heterogeneity else lam_hat
        if np.isinf(cap):
            assign = proportional_assignment(rates, n_rem)
        elif capped_mode == "waterfill":
            assign = capped_proportional_assignment(rates, n_rem, cap)
        else:  # paper-faithful: plain min(cap, share), carry the remainder
            share = largest_remainder_round(rates, n_rem)
            assign = np.minimum(share, cap).astype(np.int64)
        carried = n_rem - int(assign.sum())    # Algorithm 3 carry-over
        if assign.sum() == 0:   # degenerate rounding for tiny n_rem
            break
        # communication overhead, eq. (1): only units beyond the leftover
        if iters > 0:
            n_comm += float(np.maximum(assign - n_left_prev, 0).sum())
        lam_t = (lam if sched is None
                 else sched[min(iters, sched.shape[0] - 1)])
        t_star, done = _iteration_outcome(assign, lam_t, rng)
        iters += 1
        t_iter.append(t_star)
        t_comp += t_star
        n_done += done
        n_left_prev = assign - done
        n_rem = carried + int(n_left_prev.sum())
        # online estimate, eq. (23)
        est_done += done
        est_time += t_star
        if est_time > 0:
            lam_hat = np.where(est_done > 0, est_done / est_time, 1.0)

    if n_rem > 0:
        rates = lam if cfg.known_heterogeneity else lam_hat
        assign = proportional_assignment(rates, n_rem)
        if iters > 0:
            n_comm += float(np.maximum(assign - n_left_prev, 0).sum())
        lam_t = (lam if sched is None
                 else sched[min(iters, sched.shape[0] - 1)])
        t_comp += _final_phase(assign, lam_t, rng)
        n_done += assign
        iters += 1
        t_iter.append(t_iter[-1] if t_iter else t_comp)

    stats = RunStats(t_comp=t_comp, iterations=iters, n_comm=n_comm,
                     n_done=n_done, t_iter=np.asarray(t_iter))
    stats.check_work_conserved(N)
    return stats


# ---------------------------------------------------------------------------
# the work-exchange engine through a sampler backend
# ---------------------------------------------------------------------------

def work_exchange_mc_batched(het: HetSpec, N: int, cfg: ExchangeConfig,
                             trials: int, rng: np.random.Generator,
                             capped_mode: Literal["carry", "waterfill"]
                             = "carry", keep_trials: bool = False,
                             scheme_name: str = "work_exchange",
                             backend: Optional[str] = None,
                             rate_schedule: Optional[np.ndarray] = None,
                             device=DEFAULT_DEVICE) -> MCReport:
    """All ``trials`` work-exchange runs at once through a sampler
    backend.  On ``numpy`` a single trial consumes randomness in exactly
    the order of ``simulate_work_exchange_scalar``.  ``rate_schedule``
    (optional ``(R, K)``) is the per-round service-rate schedule of the
    drifting scenarios."""
    name = resolve_backend(backend)
    dev = resolve_device(device)
    sched = (None if rate_schedule is None
             else np.asarray(rate_schedule, dtype=np.float64)[None, :, :])
    ts, its, cs = get_backend(name).work_exchange_grid(
        het.lambdas[None, :], N, cfg, int(trials), rng,
        capped_mode=capped_mode, rate_schedule=sched, device=dev)
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

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        t = float(rng.gamma(shape=N, scale=1.0 / het.lambda_sum))
        return RunStats(t_comp=t, iterations=1, n_comm=0.0,
                        n_done=self.initial_sizes(het, N))

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

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        assign = self.initial_sizes(het, N)
        t = _final_phase(assign, het.lambdas, rng)
        return RunStats(t_comp=t, iterations=1, n_comm=0.0, n_done=assign)

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

    def _scheduler_rates(self, rates: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def make_scheduler(self, unit_ids, rates=None, estimator=None,
                       threshold_frac=None) -> MasterScheduler:
        """One wait-all epoch (threshold 1e9) at the scheme's rates."""
        rates = self._scheduler_rates(np.asarray(rates, dtype=np.float64))
        return MasterScheduler(unit_ids, rates.size, rates=rates,
                               threshold_frac=1e9)


@register_scheme("fixed", aliases=("het_static", "fixed_proportional"))
class FixedScheme(_StaticScheme):
    """Section 5.1: heterogeneity-aware fixed assignment; wait for the max."""

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        return proportional_assignment(het.lambdas, N)

    def _scheduler_rates(self, rates: np.ndarray) -> np.ndarray:
        return rates


@register_scheme("uniform", aliases=("equal_static",))
class UniformScheme(_StaticScheme):
    """Naive baseline: N/K each, wait for the max (heterogeneity-blind)."""

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        return uniform_assignment(het.K, N)

    def _scheduler_rates(self, rates: np.ndarray) -> np.ndarray:
        return np.ones(rates.size)


@register_scheme("mds", aliases=("mds_opt", "mds-opt"))
class MDSScheme(Scheme):
    """Section 3: (K, L) MDS-coded run; T = L-th order statistic of
    Erlang(ceil(N/L), lambda_k).  ``L=None`` optimizes L by Monte Carlo
    (eq. 6) inside ``mc``; ``opt_trials`` bounds that inner sweep.

    All candidate L values become extra rows of ONE ``gamma_rows`` call
    through the sampler backend, and ``mc_grid`` batches the whole ``specs
    x L x trials`` cube the same way.  On the ``numpy`` backend the cube
    is drawn independently, in exactly the per-L loop's order, so the
    chosen L and every sample are bit-identical to ``mds_sweep``; on
    ``cuda`` it is the common-random-numbers sweep of the reference's
    transform backends.
    """

    redundant = True    # K * ceil(N/L) coded units are shipped for N useful
    live_cover = True   # live: complete at size-cover (== L finishers
                        # whenever ceil(N/m) == L)

    def __init__(self, L: Optional[int] = None, opt_trials: int = 64):
        self.L = L
        self.opt_trials = int(opt_trials)

    def _check_L(self, K: int) -> int:
        if not 1 <= self.L <= K:
            raise ValueError(f"L must be in [1, {K}]; got {self.L}")
        return self.L

    def _resolve_L(self, het: HetSpec, N: int,
                   rng: np.random.Generator) -> int:
        if self.L is not None:
            return self._check_L(het.K)
        # simulate() is the exact single-trial reference: sweep with the
        # exact numpy draws, on the host
        L, _ = mds_sweep_batched(het, N, self.opt_trials, rng,
                                 backend="numpy", device="cpu")[:2]
        return L

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        L = self.L if self.L is not None else het.K
        return np.full(het.K, int(np.ceil(N / L)), dtype=np.int64)

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        L = self._resolve_L(het, N, rng)
        m = int(np.ceil(N / L))
        t_k = rng.gamma(shape=m, scale=1.0 / het.lambdas)
        order = np.argsort(t_k, kind="stable")
        t = float(t_k[order[L - 1]])
        n_done = np.zeros(het.K, dtype=np.int64)
        n_done[order[:L]] = m      # the L earliest finishers are decoded
        return RunStats(t_comp=t, iterations=1,
                        n_comm=float(m * het.K - N), n_done=n_done)

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        name = resolve_backend(backend)
        dev = resolve_device(device)
        if self.L is None:
            # the K-candidate sweep only picks L*: bound its per-candidate
            # budget at opt_trials, then spend the full trial budget on the
            # winner alone (a coupled sweep's samples are correlated across
            # candidates, so its winner's always come from a fresh draw)
            sweep_trials = min(trials, self.opt_trials)
            [(L, ts)] = _mds_select_L_grid([het], N, sweep_trials, rng,
                                           name, dev)
            if ts is None or sweep_trials < trials:
                ts = mds_time_samples(het, N, L, trials, rng, backend=name,
                                      device=dev)
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
            selection = [(self._check_L(K), None)] * len(specs)
        else:
            selection = _mds_select_L_grid(specs, N, min(T, self.opt_trials),
                                           rng, name, dev)
        winners = [L for L, _ in selection]
        sweep_ts = [ts for _, ts in selection]
        if any(ts is None for ts in sweep_ts) or min(T, self.opt_trials) < T:
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
                       ) -> List[Tuple[int, Optional[np.ndarray]]]:
    """Pick L* per spec: all candidate L of all specs as grid rows of ONE
    ``gamma_rows`` dispatch.  Returns ``(L*, sweep samples at L*)`` per
    spec; the samples slot is ``None`` for coupled sweeps (cross-candidate
    correlated -- callers top up from an independent draw).

    Exact backends run the *independent* cube: spec-major then L-major
    rows, bit-identical in stream order to looping ``mds_sweep`` per
    spec.  Coupled backends (``coupled_mds_sweep``) run the
    common-random-numbers cube: per spec ONE shared trial axis, candidate
    Erlangs built as cumulative Gamma increments ``T(m_L) = T(m_{L+1}) +
    Gamma(m_L - m_{L+1})``, ``ceil(sweep_trials / 2)`` trials (floor 16).
    """
    K = specs[0].K
    G = len(specs)
    draw = get_gamma_rows(name)
    cand = list(range(1, K + 1))
    m = np.array([int(np.ceil(N / L)) for L in cand], dtype=np.float64)
    inv_lam = np.stack([1.0 / h.lambdas for h in specs])

    if get_backend(name).coupled_mds_sweep:
        ct = max(16, (int(sweep_trials) + 1) // 2)
        m_asc = m[::-1]                      # ascending m: L = K, K-1, ... 1
        diffs = np.empty(K)
        diffs[0] = m_asc[0]
        diffs[1:] = np.diff(m_asc)
        # rows spec-major then increment-major, drawn at unit rate; tied
        # increments (ceil(N/L) ties) draw at shape 1 and are zeroed
        shape_col = np.tile(np.repeat(np.maximum(diffs, 1.0), ct),
                            G)[:, None]
        t = draw(shape_col, np.ones((1, K), dtype=np.float32), rng,
                 device=device)
        t = t.reshape(G, K, ct, K)
        t *= (diffs > 0)[None, :, None, None] * inv_lam[:, None, None, :]
        cube = np.cumsum(t, axis=1)
        cube.sort(axis=3)                    # cube[g, i] = T at m_asc[i]
        out: List[Tuple[int, Optional[np.ndarray]]] = []
        for g in range(G):
            best = (1, np.inf)
            for L in cand:
                mean_t = float(cube[g, K - L, :, L - 1].mean())
                if mean_t < best[1]:
                    best = (L, mean_t)
            out.append((best[0], None))
        return out

    sweep_trials = int(sweep_trials)
    shape_col = np.tile(np.repeat(m, sweep_trials), G)[:, None]
    scale_rows = np.repeat(inv_lam, K * sweep_trials, axis=0)
    t = draw(shape_col, scale_rows, rng, device=device)
    t.sort(axis=1)
    t = t.reshape(G, K, sweep_trials, K)
    out = []
    for g in range(G):
        best_ts: Tuple[int, float, Optional[np.ndarray]] = (1, np.inf, None)
        for i, L in enumerate(cand):
            ts = t[g, i, :, L - 1]
            mean_t = float(ts.mean())
            if mean_t < best_ts[1]:
                best_ts = (L, mean_t, ts)
        out.append((best_ts[0], best_ts[2]))
    return out


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


def mds_sweep(het: HetSpec, N: int, trials: int, rng: np.random.Generator
              ) -> Tuple[int, float, np.ndarray]:
    """Eq. (6) as the per-L reference loop (numpy draws on the host): the
    baseline ``mds_sweep_batched`` on ``numpy`` is bit-identical to."""
    best: Tuple[int, float, Optional[np.ndarray]] = (1, np.inf, None)
    for L in range(1, het.K + 1):
        m = int(np.ceil(N / L))
        t = rng.gamma(shape=m, scale=1.0 / het.lambdas,
                      size=(trials, het.K))
        t.sort(axis=1)
        ts = t[:, L - 1]
        mean_t = float(ts.mean())
        if mean_t < best[1]:
            best = (L, mean_t, ts)
    return best  # type: ignore[return-value]


def mds_sweep_batched(het: HetSpec, N: int, trials: int,
                      rng: np.random.Generator,
                      backend: Optional[str] = None,
                      device=DEFAULT_DEVICE
                      ) -> Tuple[int, float, np.ndarray]:
    """Eq. (6) with every candidate L as extra grid rows of ONE batched
    ``gamma_rows`` draw (rows L-major ``(K * trials, K)``; on ``numpy``
    bit-identical to ``mds_sweep``).  Returns ``(L*, E[T(L*)], samples
    at L*)``."""
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
    """Shared machinery of the known/unknown work-exchange variants.

    ``engine="loop"`` runs ``mc`` as a per-trial loop of the scalar
    ``simulate`` (the validation reference); ``capped_mode="waterfill"``
    re-offers units freed by the storage cap to uncapped workers (the
    ``numpy`` backend and the scalar path only)."""

    known: bool = True
    plan_wait_all = False
    supports_rate_schedule = True   # drifting scenarios thread through

    def __init__(self, threshold_frac: float = 0.01,
                 storage_cap_frac: Optional[float] = 1.0,
                 capped_mode: Literal["carry", "waterfill"] = "carry",
                 max_iterations: int = 10_000,
                 engine: Literal["vectorized", "loop"] = "vectorized"):
        if engine not in ("vectorized", "loop"):
            raise ValueError(f"unknown engine {engine!r}")
        if capped_mode not in ("carry", "waterfill"):
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

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator,
                 rate_schedule: Optional[np.ndarray] = None) -> RunStats:
        return simulate_work_exchange_scalar(het, N, self.config(), rng,
                                             self.capped_mode,
                                             rate_schedule=rate_schedule)

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           rate_schedule: Optional[np.ndarray] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        if self.engine == "loop":    # the per-trial validation reference
            if rate_schedule is None:
                return super().mc(het, N, trials, rng, keep_trials,
                                  backend=backend, device=device)
            validate_backend(backend)
            resolve_device(device)
            ts, its, cs = (np.empty(trials) for _ in range(3))
            for i in range(trials):
                s = self.simulate(het, N, rng, rate_schedule=rate_schedule)
                ts[i], its[i], cs[i] = s.t_comp, s.iterations, s.n_comm
            return _report(self.name, ts, its, cs, keep_trials)
        return work_exchange_mc_batched(het, N, self.config(), trials, rng,
                                        self.capped_mode, keep_trials,
                                        scheme_name=self.name,
                                        backend=backend,
                                        rate_schedule=rate_schedule,
                                        device=device)

    def mc_grid(self, het_specs: Sequence[HetSpec], N: int, trials: int,
                rng: np.random.Generator, keep_trials: bool = False,
                backend: Optional[str] = None,
                rate_schedule: Optional[np.ndarray] = None,
                device=DEFAULT_DEVICE) -> List[MCReport]:
        """One engine dispatch for the whole ``(het_specs) x trials``
        batch.  Mixed-K grids and the ``engine="loop"`` reference fall
        back to the per-spec loop.  ``rate_schedule`` (optional ``(G, R,
        K)``) is the drifting-scenario contract: service draws follow it,
        assignments stay nominal / estimated."""
        specs = list(het_specs)
        sched = (None if rate_schedule is None
                 else np.asarray(rate_schedule, dtype=np.float64))
        if (self.engine == "loop" or not specs
                or len({h.K for h in specs}) != 1):
            return [self.mc(het, N, trials, rng, keep_trials=keep_trials,
                            backend=backend, device=device,
                            rate_schedule=None if sched is None
                            else sched[g])
                    for g, het in enumerate(specs)]
        name = resolve_backend(backend)
        lam = np.stack([h.lambdas for h in specs])
        arrays = get_backend(name).work_exchange_grid(
            lam, N, self.config(), int(trials), rng,
            capped_mode=self.capped_mode, rate_schedule=sched,
            device=resolve_device(device))
        return _grid_reports(self.name, specs, int(trials), arrays,
                             keep_trials, name)

    def make_scheduler(self, unit_ids, rates=None, estimator=None,
                       threshold_frac=None) -> MasterScheduler:
        """Algorithm 1 at the given rates (known), or Algorithm 3 with
        ``estimator`` (unknown; a fresh cumulative one when None)."""
        thr = self.threshold_frac if threshold_frac is None else threshold_frac
        if self.known:
            rates = np.asarray(rates, dtype=np.float64)
            return MasterScheduler(unit_ids, rates.size, rates=rates,
                                   threshold_frac=thr,
                                   storage_cap_frac=self.storage_cap_frac)
        K = np.asarray(rates).size
        return MasterScheduler(unit_ids, K, rates=None, estimator=estimator,
                               threshold_frac=thr,
                               storage_cap_frac=self.storage_cap_frac)


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
    the first known and the first unknown ``_WorkExchangeBase`` on the
    vectorized engine with the paper's ``carry`` capped mode, sharing
    ``threshold_frac`` and ``max_iterations`` (the fused launch runs one
    round loop for both)."""
    known_key = unknown_key = None
    for key, sch in schemes.items():
        if (not isinstance(sch, _WorkExchangeBase)
                or sch.engine != "vectorized"
                or sch.capped_mode != "carry"):
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
    one engine call where the backend has a panel engine (``cuda``: ONE
    kernel launch, known rows stacked on unknown rows with a per-row
    flag; ``torch``: the coupled pair on common random numbers).
    Everything else runs its own ``mc_grid``.

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
            if panel_fn is not None and specs
            and len({h.K for h in specs}) == 1 else None)
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


# ---------------------------------------------------------------------------
# beyond-paper scenario schemes
# ---------------------------------------------------------------------------

@register_scheme("het_mds", aliases=("hcmm",))
class HetMDSScheme(Scheme):
    """Heterogeneous coded loads (Reisizadeh et al. HCMM / Kim et al.).

    Instead of the paper's symmetric (K, L) code, each worker k gets a coded
    load l_k proportional to its rate with aggregate redundancy r >= 1
    (sum l_k = r N); the run completes at the earliest time the finished
    workers' loads cover N.  At r = 1 with exact rates this is the
    heterogeneity-aware fixed assignment; larger r trades completion time
    (every load scales by ~r under light-tailed service) for tolerance of
    stragglers and rate mismatch -- one draw per trial, no reassignment.
    The draws are numpy's on the host whatever the backend.
    """

    redundant = True
    live_cover = True   # cover >= N is this scheme's own completion rule

    def __init__(self, redundancy: float = 1.25):
        if redundancy < 1.0:
            raise ValueError("redundancy must be >= 1")
        self.redundancy = float(redundancy)

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        total = int(np.ceil(self.redundancy * N))
        return largest_remainder_round(het.lambdas, total)

    @staticmethod
    def _cover_times_rows(load_rows: np.ndarray, scale_rows: np.ndarray,
                          N: int, rng: np.random.Generator) -> np.ndarray:
        """Per-row cover time: earliest finish time at which the finished
        workers' coded loads jointly cover N (rows are independent runs)."""
        t = np.full(load_rows.shape, np.inf)
        busy = load_rows > 0
        t[busy] = rng.gamma(shape=load_rows[busy], scale=scale_rows[busy])
        order = np.argsort(t, axis=1, kind="stable")
        covered = np.cumsum(np.take_along_axis(load_rows, order, axis=1),
                            axis=1) >= N
        first = np.argmax(covered, axis=1)               # first covering rank
        t_sorted = np.take_along_axis(t, order, axis=1)
        return t_sorted[np.arange(first.size), first]

    def _cover_times(self, het: HetSpec, N: int, trials: int,
                     rng: np.random.Generator) -> np.ndarray:
        loads = self.initial_sizes(het, N)
        return self._cover_times_rows(
            np.broadcast_to(loads, (trials, het.K)),
            np.broadcast_to(1.0 / het.lambdas, (trials, het.K)), N, rng)

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        loads = self.initial_sizes(het, N)
        t = float(self._cover_times(het, N, 1, rng)[0])
        return RunStats(t_comp=t, iterations=1,
                        n_comm=float(loads.sum() - N), n_done=loads)

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        validate_backend(backend)
        resolve_device(device)
        loads = self.initial_sizes(het, N)
        ts = self._cover_times(het, N, trials, rng)
        return _report(self.name, ts, np.ones(trials),
                       np.full(trials, float(loads.sum() - N)), keep_trials,
                       extra={"redundancy": self.redundancy})

    def mc_grid(self, het_specs: Sequence[HetSpec], N: int, trials: int,
                rng: np.random.Generator, keep_trials: bool = False,
                backend: Optional[str] = None,
                device=DEFAULT_DEVICE) -> List[MCReport]:
        """Cover times for the whole grid in one (G * trials, K) batch."""
        validate_backend(backend)
        resolve_device(device)
        specs = list(het_specs)
        if not specs or len({h.K for h in specs}) != 1:
            return super().mc_grid(specs, N, trials, rng,
                                   keep_trials=keep_trials, backend=backend,
                                   device=device)
        T = int(trials)
        loads = np.stack([self.initial_sizes(h, N) for h in specs])
        ts = self._cover_times_rows(
            np.repeat(loads, T, axis=0),
            np.repeat(np.stack([1.0 / h.lambdas for h in specs]), T, axis=0),
            N, rng).reshape(len(specs), T)
        return [_report(self.name, ts[g], np.ones(T),
                        np.full(T, float(loads[g].sum() - N)), keep_trials,
                        extra={"redundancy": self.redundancy,
                               "backend": "numpy"})
                for g in range(len(specs))]


@register_scheme("trace_replay")
class TraceReplayScheme(Scheme):
    """Replay measured per-epoch service-rate traces through the id-aware
    master protocol (``MasterScheduler`` + ``VirtualWorkerPool``'s
    measured-trace path).

    Trace sources, in precedence order:

    ``traces``
        A literal (K, E) array of observed rates (wrapping after E
        epochs).
    ``corpus``
        A named measured-trace corpus under ``results/traces/``
        (``repro_torch.scenarios.traces``): the scheme replays the corpus
        window selected by ``worker_offset`` / ``epoch_start`` /
        ``epochs`` -- the same windowing the ``trace_corpus`` scenario
        family uses, so ``scheme_spec("trace_replay", corpus=...)``
        inside an experiment replays exactly the grid point's trace.
    *(neither)*
        A synthetic drift profile perturbs the HetSpec rates by
        +-``drift`` over ``period`` epochs, phase-shifted per worker.

    The scheduler sees only the *nominal* rates; realized epochs run at
    the trace rates.
    """

    plan_wait_all = False

    def __init__(self, traces: Optional[np.ndarray] = None,
                 drift: float = 0.3, period: int = 8,
                 threshold_frac: float = 0.05,
                 corpus: Optional[str] = None, worker_offset: int = 0,
                 epoch_start: int = 0, epochs: Optional[int] = None):
        self.traces = None if traces is None else np.asarray(traces, float)
        self.drift = float(drift)
        self.period = int(period)
        self.threshold_frac = float(threshold_frac)
        self.corpus = corpus
        self.worker_offset = int(worker_offset)
        self.epoch_start = int(epoch_start)
        self.epochs = None if epochs is None else int(epochs)

    def _traces_for(self, het: HetSpec) -> np.ndarray:
        if self.traces is not None:
            if self.traces.shape[0] != het.K:
                raise ValueError(f"traces have {self.traces.shape[0]} "
                                 f"workers; het has {het.K}")
            return self.traces
        if self.corpus is not None:
            from ..scenarios.traces import load_corpus
            return load_corpus(self.corpus).window(
                het.K, self.worker_offset, self.epoch_start, self.epochs)
        e = np.arange(self.period)
        k = np.arange(het.K)[:, None]
        profile = 1.0 + self.drift * np.sin(
            2.0 * np.pi * (e[None, :] / self.period + k / het.K))
        return np.maximum(het.lambdas[:, None] * profile, 1e-9)

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        return proportional_assignment(het.lambdas, N)

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        from .runtime import VirtualWorkerPool
        sched = MasterScheduler(range(N), het.K, rates=het.lambdas,
                                threshold_frac=self.threshold_frac)
        pool = VirtualWorkerPool(het.lambdas, rng=rng,
                                 traces=self._traces_for(het))
        n_done = np.zeros(het.K, dtype=np.int64)
        guard = 0
        while not sched.finished and guard < 100_000:
            a = sched.next_assignment()
            if a is None:
                break
            elapsed, done = pool.run_epoch(a)
            sched.report(done, elapsed)
            n_done += done
            guard += 1
        return RunStats(t_comp=sched.t_comp, iterations=sched.iterations,
                        n_comm=float(sched.n_comm), n_done=n_done)

    def make_scheduler(self, unit_ids, rates=None, estimator=None,
                       threshold_frac=None) -> MasterScheduler:
        thr = self.threshold_frac if threshold_frac is None else threshold_frac
        rates = np.asarray(rates, dtype=np.float64)
        return MasterScheduler(unit_ids, rates.size, rates=rates,
                               threshold_frac=thr)


# ---------------------------------------------------------------------------
# coded scheme
# ---------------------------------------------------------------------------

@register_scheme("gradient_coded")
class GradientCodedScheme(Scheme):
    """Fractional-repetition coding translated to the unit-count model:
    each unit is replicated s+1 times; the run completes at the earliest
    time the finished workers jointly cover all N units (no reassignment,
    no coordination -- redundancy instead of exchange)."""

    redundant = True
    # make_scheduler returns a one-shot CoverScheduler (whole-queue
    # finish-time feedback), not a MasterScheduler: training executors
    # branch on it
    cover_scheduler = True

    def __init__(self, s: int = 1):
        self.s = int(s)

    def _coding(self, het: HetSpec):
        from .coded import GradientCoding
        K = het.K - het.K % (self.s + 1)    # FR needs (s+1) | K; drop extras
        if K < self.s + 1:
            raise ValueError(f"need >= {self.s + 1} workers for s={self.s}")
        return GradientCoding(K=K, s=self.s), K

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        gc, K = self._coding(het)
        sizes = np.zeros(het.K, dtype=np.int64)
        sizes[:K] = [len(o) for o in gc.assignment(N)]
        return sizes

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        gc, K = self._coding(het)
        owners = gc.assignment(N)
        sizes = np.array([len(o) for o in owners], dtype=np.int64)
        t_k = rng.gamma(shape=np.maximum(sizes, 1),
                        scale=1.0 / het.lambdas[:K])
        order = np.argsort(t_k, kind="stable")
        covered: set = set()
        n_done = np.zeros(het.K, dtype=np.int64)
        t_done = float(t_k[order[-1]])
        for w in order:
            fresh = set(owners[w]) - covered
            covered |= fresh
            n_done[w] = len(fresh)          # credit first replica to finish
            if len(covered) == N:
                t_done = float(t_k[w])
                break
        return RunStats(t_comp=t_done, iterations=1,
                        n_comm=float(sizes.sum() - N), n_done=n_done)

    def make_scheduler(self, unit_ids, rates=None, estimator=None,
                       threshold_frac=None) -> CoverScheduler:
        """A ``CoverScheduler`` over ``len(rates)`` workers."""
        K = np.asarray(rates, dtype=np.float64).size
        return CoverScheduler(unit_ids, K, s=self.s)


@register_scheme("hedged", aliases=("replicate_slowest", "hedged_requests"))
class HedgedScheme(Scheme):
    """Replication-on-slowest (hedged requests).

    The fastest worker is withheld as a hot spare; the other K-1 workers
    take the heterogeneity-aware proportional shares of all N units.  The
    spare mirrors the queue of the predicted straggler -- the lowest-rate
    loaded worker, which has both the largest expected completion time
    and (Var[T_k] = n_k / lambda_k^2) the heaviest tail -- and whichever
    replica finishes first counts.  Classic tail-latency hedging: pay one
    duplicated shard instead of coordination rounds; ``n_comm`` is the
    duplicated units.  With K = 1 there is nobody to hedge with and the
    scheme degenerates to the fixed assignment.  The draws are numpy's on
    the host whatever the backend.
    """

    redundant = True    # the straggler's shard ships twice
    live_cover = True   # cover >= N == the replica race (all others plus
                        # whichever of straggler/spare finishes first)

    def _layout(self, het: HetSpec, N: int):
        """Per-worker primary loads + (spare, straggler) worker ids."""
        loads = np.zeros(het.K, dtype=np.int64)
        if het.K == 1:
            loads[0] = N
            return loads, None, None
        spare = int(np.argmax(het.lambdas))
        others = np.delete(np.arange(het.K), spare)
        loads[others] = proportional_assignment(het.lambdas[others], N)
        loaded = others[loads[others] > 0]
        if loaded.size == 0:
            return loads, None, None
        strag = int(loaded[np.argmin(het.lambdas[loaded])])
        return loads, spare, strag

    def initial_sizes(self, het: HetSpec, N: int) -> np.ndarray:
        loads, spare, strag = self._layout(het, N)
        sizes = loads.copy()
        if spare is not None:
            sizes[spare] = loads[strag]      # the duplicated shard
        return sizes

    def _finish_times(self, het: HetSpec, N: int, trials: int,
                      rng: np.random.Generator):
        """Per-trial ``(t_comp, n_comm, t_strag_raw, t_spare)`` plus the
        layout, all trials at once (draw order: primaries, then spare)."""
        loads, spare, strag = self._layout(het, N)
        busy = loads > 0
        t_k = np.full((trials, het.K), -np.inf)   # idle never sets the max
        t_k[:, busy] = rng.gamma(shape=loads[busy],
                                 scale=1.0 / het.lambdas[busy],
                                 size=(trials, int(busy.sum())))
        if spare is None:
            return (t_k.max(axis=1), np.zeros(trials), loads, spare, strag,
                    None, None)
        t_spare = rng.gamma(shape=loads[strag],
                            scale=1.0 / het.lambdas[spare], size=trials)
        t_eff = t_k.copy()
        t_eff[:, strag] = np.minimum(t_k[:, strag], t_spare)
        t_comp = t_eff.max(axis=1)          # spare's column is -inf
        n_comm = np.full(trials, float(loads[strag]))
        return t_comp, n_comm, loads, spare, strag, t_k[:, strag], t_spare

    def simulate(self, het: HetSpec, N: int,
                 rng: np.random.Generator) -> RunStats:
        t_comp, n_comm, loads, spare, strag, t_strag, t_spare = \
            self._finish_times(het, N, 1, rng)
        n_done = loads.copy()
        if spare is not None and float(t_spare[0]) < float(t_strag[0]):
            # the spare's replica finished first: credit it, not the
            # straggler (exactly one replica counts -- work conserved)
            n_done[spare] = loads[strag]
            n_done[strag] = 0
        return RunStats(t_comp=float(t_comp[0]), iterations=1,
                        n_comm=float(n_comm[0]), n_done=n_done)

    def mc(self, het: HetSpec, N: int, trials: int,
           rng: np.random.Generator, keep_trials: bool = False,
           backend: Optional[str] = None,
           device=DEFAULT_DEVICE) -> MCReport:
        validate_backend(backend)
        resolve_device(device)
        t_comp, n_comm, _, spare, strag, _, _ = \
            self._finish_times(het, N, trials, rng)
        extra = {} if spare is None else {"spare": float(spare),
                                          "straggler": float(strag)}
        return _report(self.name, t_comp, np.ones(trials), n_comm,
                       keep_trials, extra=extra)


__all__ = [
    "MCReport", "Scheme", "SCHEME_REGISTRY", "register_scheme",
    "get_scheme", "list_schemes", "simulate_work_exchange_scalar",
    "work_exchange_mc_batched", "mc_grid_panel", "mds_sweep",
    "mds_sweep_batched", "mds_time_samples",
    "OracleScheme", "FixedScheme", "UniformScheme", "MDSScheme",
    "WorkExchangeScheme", "WorkExchangeUnknownScheme", "HetMDSScheme",
    "TraceReplayScheme", "GradientCodedScheme", "HedgedScheme",
]
