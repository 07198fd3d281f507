"""Online heterogeneity (service-rate) estimators: the port's own copy of
``repro.core.estimator`` (host numpy), line for line, so the rates it
estimates are the reference's bits.

The paper's estimator (eq. 23) is the cumulative empirical rate
    lambda_hat_k = sum_j N_done^(k,j) / sum_j T_comp^(j).
We provide it verbatim plus two beyond-paper variants used by the
production scheduler:

* ``EMARateEstimator`` -- exponentially-weighted rate, tracks *drifting*
  heterogeneity (e.g. thermal throttling, co-tenancy changes) that the
  cumulative estimator averages away.
* ``GammaPosteriorEstimator`` -- conjugate Bayesian estimate: with
  exponential service times, the posterior over lambda_k after observing
  n events in time t (Gamma(a0 + n, b0 + t)) gives both a point estimate
  and a credible interval; the scheduler can assign by a pessimistic
  quantile to hedge against under-sampled workers.
"""
from __future__ import annotations

import numpy as np

from .registry import Registry


class RateEstimator:
    """Interface: observe per-iteration (done_counts, elapsed) and expose rates."""

    def __init__(self, K: int, prior_rate: float = 1.0):
        self.K = K
        self.prior_rate = float(prior_rate)

    def update(self, done: np.ndarray, elapsed: float) -> None:
        raise NotImplementedError

    def rates(self) -> np.ndarray:
        raise NotImplementedError


class CumulativeRateEstimator(RateEstimator):
    """Paper eq. (23). Initialized to lambda_hat = prior (paper uses 1)."""

    def __init__(self, K: int, prior_rate: float = 1.0):
        super().__init__(K, prior_rate)
        self.total_done = np.zeros(K, dtype=np.float64)
        self.total_time = 0.0

    def update(self, done: np.ndarray, elapsed: float) -> None:
        self.total_done += np.asarray(done, dtype=np.float64)
        self.total_time += float(elapsed)

    def rates(self) -> np.ndarray:
        if self.total_time <= 0:
            return np.full(self.K, self.prior_rate)
        r = self.total_done / self.total_time
        # a worker that has produced nothing yet keeps the prior so it is
        # still assigned work (otherwise it would starve forever)
        return np.where(self.total_done > 0, np.maximum(r, 1e-12),
                        self.prior_rate)


class EMARateEstimator(RateEstimator):
    """Beyond-paper: EMA over per-iteration empirical rates."""

    def __init__(self, K: int, prior_rate: float = 1.0, alpha: float = 0.4):
        super().__init__(K, prior_rate)
        self.alpha = float(alpha)
        self._rate = np.full(K, float(prior_rate))
        self._seen = np.zeros(K, dtype=bool)

    def update(self, done: np.ndarray, elapsed: float) -> None:
        if elapsed <= 0:
            return
        inst = np.asarray(done, dtype=np.float64) / float(elapsed)
        first = ~self._seen & (inst > 0)
        ema = (1 - self.alpha) * self._rate + self.alpha * inst
        # a worker with no observation yet holds the prior outright:
        # running its zero through the EMA would decay the prior toward
        # zero and starve a worker that simply hasn't reported (slow
        # start, long first shard) before it ever produces a unit
        self._rate = np.where(first, inst,
                              np.where(self._seen, ema, self._rate))
        self._seen |= inst > 0

    def rates(self) -> np.ndarray:
        return np.maximum(self._rate, 1e-12)


class GammaPosteriorEstimator(RateEstimator):
    """Beyond-paper: conjugate Gamma posterior over exponential service rates.

    posterior: lambda_k ~ Gamma(a0 + done_k, b0 + t_k). ``quantile`` < 0.5
    gives pessimistic assignment (hedges stragglers), 0.5 ~ median.
    """

    def __init__(self, K: int, prior_rate: float = 1.0,
                 a0: float = 1.0, quantile: float = 0.5):
        super().__init__(K, prior_rate)
        self.a0 = float(a0)
        self.b0 = self.a0 / max(prior_rate, 1e-12)
        self.quantile = float(quantile)
        self.done = np.zeros(K, dtype=np.float64)
        self.time = np.zeros(K, dtype=np.float64)

    def update(self, done: np.ndarray, elapsed: float) -> None:
        self.done += np.asarray(done, dtype=np.float64)
        self.time += float(elapsed)

    def rates(self) -> np.ndarray:
        a = self.a0 + self.done
        b = self.b0 + self.time
        if abs(self.quantile - 0.5) < 1e-9:
            return np.maximum(a / b, 1e-12)  # posterior mean ~ median for large a
        # Wilson-Hilferty approximation of the Gamma quantile
        z = _norm_ppf(self.quantile)
        wh = a * (1 - 1 / (9 * a) + z / (3 * np.sqrt(a))) ** 3
        return np.maximum(wh / b, 1e-12)


def _norm_ppf(q: float) -> float:
    """Acklam's inverse-normal approximation (no scipy dependency)."""
    if not 0 < q < 1:
        raise ValueError("quantile in (0,1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        ql = np.sqrt(-2 * np.log(q))
        return (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / \
               ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    if q > phigh:
        ql = np.sqrt(-2 * np.log(1 - q))
        return -(((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / \
               ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    ql = q - 0.5
    r = ql * ql
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * ql / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


ESTIMATOR_REGISTRY: Registry = Registry("estimator")
ESTIMATOR_REGISTRY.register("cumulative", CumulativeRateEstimator)
ESTIMATOR_REGISTRY.register("ema", EMARateEstimator)
ESTIMATOR_REGISTRY.register("bayes", GammaPosteriorEstimator)


def make_estimator(kind: str, K: int, prior_rate: float = 1.0,
                   **kw) -> RateEstimator:
    """Instantiate a registered estimator; unknown kinds raise the
    registry's uniform ``KeyError`` listing the registered names."""
    return ESTIMATOR_REGISTRY.get(kind)(K, prior_rate, **kw)
