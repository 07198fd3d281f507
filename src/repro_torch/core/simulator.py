"""DEPRECATED free-function surface over the Monte-Carlo engine: the port
of ``repro.core.simulator``.

Everything here is a thin shim over ``repro_torch.core.schemes`` -- the
registry-driven Scheme API (``get_scheme(name).mc(het, N, trials,
rng)``).  New code should go through the registry; these wrappers keep
the original per-scheme entry points importable and numerically
identical to the reference's shims, which draw with the exact numpy
engine: so do these, on the host.  The Monte-Carlo means take
``device=`` as every ``mc`` does (default ``"cuda"``, which raises
without a card); the single-trial paths have no device.

``work_exchange_mc`` runs the trial-vectorized engine; pass
``engine="loop"`` for the per-trial loop.
"""
from __future__ import annotations

import warnings
from typing import Literal

import numpy as np

from ..device import DEFAULT_DEVICE, resolve_device
from . import schemes
from .schemes import MCReport as ExchangeMC    # legacy name; same fields +
from .types import ExchangeConfig, HetSpec, RunStats   # t_std/i_std/c_std


def _deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.simulator.{name} is deprecated; use "
        f"repro_torch.core.schemes.get_scheme(...) instead",
        DeprecationWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# single-trial paths (exact numerics at fixed seed)
# ---------------------------------------------------------------------------

def simulate_work_exchange(het: HetSpec, N: int, cfg: ExchangeConfig,
                           rng: np.random.Generator,
                           capped_mode: Literal["carry", "waterfill"] = "carry",
                           ) -> RunStats:
    """Algorithms 1/3, one trial.  Use get_scheme("work_exchange")."""
    _deprecated("simulate_work_exchange")
    return schemes.simulate_work_exchange_scalar(het, N, cfg, rng, capped_mode)


def simulate_oracle(het: HetSpec, N: int, rng: np.random.Generator) -> float:
    """Theorem 1 sample, one trial.  Use get_scheme("oracle")."""
    _deprecated("simulate_oracle")
    return float(rng.gamma(shape=N, scale=1.0 / het.lambda_sum))


# ---------------------------------------------------------------------------
# Monte-Carlo means
# ---------------------------------------------------------------------------

def mds_mean_time(het: HetSpec, N: int, L: int, trials: int,
                  rng: np.random.Generator, device=DEFAULT_DEVICE) -> float:
    _deprecated("mds_mean_time")
    return float(schemes.mds_time_samples(het, N, L, trials, rng,
                                          backend="numpy",
                                          device=device).mean())


def mds_optimize(het: HetSpec, N: int, trials: int,
                 rng: np.random.Generator,
                 device=DEFAULT_DEVICE) -> tuple[int, float]:
    """Eq. (6) L sweep.  Use get_scheme("mds").mc(...) (extra["L"])."""
    _deprecated("mds_optimize")
    resolve_device(device)
    L, mean_t, _ = schemes.mds_sweep(het, N, trials, rng)
    return L, mean_t


def fixed_mean_time(het: HetSpec, N: int, trials: int,
                    rng: np.random.Generator, device=DEFAULT_DEVICE) -> float:
    _deprecated("fixed_mean_time")
    return schemes.FixedScheme().mc(het, N, trials, rng,
                                    device=device).t_comp


def oracle_mean_time_mc(het: HetSpec, N: int, trials: int,
                        rng: np.random.Generator,
                        device=DEFAULT_DEVICE) -> float:
    _deprecated("oracle_mean_time_mc")
    return schemes.OracleScheme().mc(het, N, trials, rng,
                                     device=device).t_comp


def work_exchange_mc(het: HetSpec, N: int, cfg: ExchangeConfig, trials: int,
                     rng: np.random.Generator,
                     capped_mode: Literal["carry", "waterfill"] = "carry",
                     engine: Literal["vectorized", "loop"] = "vectorized",
                     device=DEFAULT_DEVICE) -> ExchangeMC:
    """Work-exchange MC.  Use get_scheme("work_exchange[_unknown]").mc."""
    _deprecated("work_exchange_mc")
    if engine == "loop":
        resolve_device(device)
        ts, its, cs = np.empty(trials), np.empty(trials), np.empty(trials)
        for i in range(trials):
            s = schemes.simulate_work_exchange_scalar(het, N, cfg, rng,
                                                      capped_mode)
            ts[i], its[i], cs[i] = s.t_comp, s.iterations, s.n_comm
        return schemes._report("work_exchange", ts, its, cs)
    return schemes.work_exchange_mc_batched(het, N, cfg, trials, rng,
                                            capped_mode, backend="numpy",
                                            device=device)
