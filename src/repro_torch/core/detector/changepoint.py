"""Online change-point detection over the iteration-time series (paper §5.2).

Three detectors, same core interface (`update(x) -> bool`):

* `BOCPD` — Bayesian online change-point detection (Adams–MacKay style, the
  paper cites Agudelo-España et al. [1]): Normal-Inverse-Gamma conjugate
  model, Student-t predictive, constant hazard. A change point is flagged
  when the posterior mass of "run length < lag" exceeds a threshold.
* `CusumDetector` — one-sided CUSUM on standardized residuals; cheaper and
  what the large-scale simulator uses per DP group.
* `SlopeDriftDetector` — windowed least-squares slope test for *creeping*
  degradations (slow ramps): CUSUM needs the cumulative level shift to cross
  its threshold inside one baseline epoch, which repeated rebaselining after
  reconfigurations defeats; a significant positive trend fires even when
  every individual step is below the CUSUM slack. Runs alongside CUSUM when
  the failure-lifecycle drift policy is enabled (see
  ``repro.core.detector.lifecycle`` in the reference
  package).

All are pure-python/numpy and O(window) per update, satisfying the paper's
"lightweight enough for online per-iteration detection" requirement.

A copy of `repro.core.detector.changepoint`, kept here so that the port runs
the Detector on times measured on the card without importing the JAX
package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class BOCPD:
    hazard: float = 1.0 / 100.0  # P(change at any step)
    max_run: int = 256  # truncate run-length distribution
    lag: int = 3  # declare change when P(run < lag) is high
    threshold: float = 0.5
    # NIG prior (weak): mu0, kappa0, alpha0, beta0
    mu0: float = 0.0
    kappa0: float = 0.1
    alpha0: float = 1.0
    beta0: float = 1.0
    warmup: int = 8

    def __post_init__(self):
        self._warm: list = []
        self._calibrated = False
        self._reset_state()

    def _reset_state(self):
        self._r = np.array([1.0])  # run-length posterior
        self._mu = np.array([self.mu0])
        self._kappa = np.array([self.kappa0])
        self._alpha = np.array([self.alpha0])
        self._beta = np.array([self.beta0])
        self._n = 0

    def _calibrate(self):
        """Scale the NIG prior to the warm-up window: with a fixed beta0 the
        prior variance swamps low-noise series and big shifts look small."""
        arr = np.asarray(self._warm, dtype=np.float64)
        mean = float(arr.mean())
        var = float(max(arr.var(ddof=1), (0.01 * abs(mean)) ** 2, 1e-12))
        self.mu0 = mean
        self.kappa0 = 1.0
        self.alpha0 = 2.0
        self.beta0 = var * self.alpha0  # E[sigma^2] ~= warm-up variance
        self._calibrated = True
        self._reset_state()
        for x in self._warm:  # replay warm-up under the calibrated prior
            self._step(float(x))

    @staticmethod
    def _gammaln(x):
        """Stirling-series log-gamma (avoids a scipy dependency)."""
        x = np.asarray(x, dtype=np.float64)
        # reflection-free: x here is always > 0.5
        coefs = [
            76.18009172947146, -86.50532032941677, 24.01409824083091,
            -1.231739572450155, 0.1208650973866179e-2, -0.5395239384953e-5,
        ]
        y = x
        tmp = x + 5.5
        tmp -= (x + 0.5) * np.log(tmp)
        ser = np.full_like(x, 1.000000000190015)
        for c in coefs:
            y = y + 1.0
            ser = ser + c / y
        return -tmp + np.log(2.5066282746310005 * ser / x)

    def _student_t_logpdf(self, x):
        df = 2.0 * self._alpha
        scale2 = self._beta * (self._kappa + 1.0) / (self._alpha * self._kappa)
        g = self._gammaln
        return (
            g((df + 1.0) / 2.0)
            - g(df / 2.0)
            - 0.5 * np.log(np.pi * df * scale2)
            - (df + 1.0) / 2.0 * np.log1p((x - self._mu) ** 2 / (df * scale2))
        )

    def update(self, x: float) -> bool:
        """Ingest one observation; True iff a change point is detected."""
        if not self._calibrated:
            self._warm.append(float(x))
            if len(self._warm) >= self.warmup:
                self._calibrate()
            return False
        self._step(float(x))
        return float(self._r[: self.lag].sum()) > self.threshold

    def _step(self, x: float):
        self._n += 1
        logpred = self._student_t_logpdf(float(x))
        pred = np.exp(np.clip(logpred, -700, 50))
        growth = self._r * pred * (1.0 - self.hazard)
        cp = float(np.sum(self._r * pred * self.hazard))
        new_r = np.concatenate([[cp], growth])
        new_r /= max(new_r.sum(), 1e-300)

        # posterior updates per hypothesis (prepend the prior for run=0)
        kappa1 = self._kappa + 1.0
        mu1 = (self._kappa * self._mu + x) / kappa1
        alpha1 = self._alpha + 0.5
        beta1 = self._beta + 0.5 * self._kappa * (x - self._mu) ** 2 / kappa1
        self._mu = np.concatenate([[self.mu0], mu1])
        self._kappa = np.concatenate([[self.kappa0], kappa1])
        self._alpha = np.concatenate([[self.alpha0], alpha1])
        self._beta = np.concatenate([[self.beta0], beta1])
        self._r = new_r
        if len(self._r) > self.max_run:
            self._r = self._r[: self.max_run]
            self._r /= self._r.sum()
            self._mu = self._mu[: self.max_run]
            self._kappa = self._kappa[: self.max_run]
            self._alpha = self._alpha[: self.max_run]
            self._beta = self._beta[: self.max_run]

    def reset(self):
        self._warm = []
        self._calibrated = False
        self._reset_state()


@dataclass
class CusumDetector:
    """One-sided CUSUM on standardized deviations from a running baseline.

    Detects sustained *increases* in iteration time (fail-slow direction).
    The baseline (mean/std) freezes once warm so the post-change points do
    not contaminate it.
    """

    k: float = 0.5  # slack, in std units
    h: float = 5.0  # decision threshold, in std units
    warmup: int = 12
    _hist: list = field(default_factory=list)
    _s: float = 0.0
    _prev_s: float = 0.0  # _s before the last update (discard_last rewind)
    _mean: float = 0.0
    _std: float = 1.0
    _frozen: bool = False

    def update(self, x: float) -> bool:
        if not self._frozen:
            self._hist.append(float(x))
            if len(self._hist) >= self.warmup:
                arr = np.asarray(self._hist, dtype=np.float64)
                self._mean = float(arr.mean())
                self._std = float(max(arr.std(ddof=1), 1e-9, 0.01 * abs(self._mean)))
                self._frozen = True
            return False
        z = (float(x) - self._mean) / self._std
        self._prev_s = self._s
        self._s = max(0.0, self._s + z - self.k)
        if self._s > self.h:
            self._s = 0.0
            return True
        return False

    def discard_last(self):
        """Remove the last point's contribution (paper: benign change points
        are removed from the series so they don't perturb later detection).

        Restores ``_s`` to its value before the last ``update`` — i.e. the
        last z-increment (and, when the point pushed ``_s`` over ``h``, the
        fire-reset to zero) is undone, so a benign workload spike neither
        accumulates toward a spurious change point nor erases legitimately
        accumulated drift evidence. During warm-up the point is dropped from
        the baseline window instead (a companion drift detector can fire
        before CUSUM is frozen)."""
        if not self._frozen:
            if self._hist:
                self._hist.pop()
            return
        self._s = self._prev_s

    def clear_evidence(self):
        """Drop the accumulated evidence but keep the frozen baseline — used
        when a validation pass has just certified the fleet healthy, proving
        whatever ``_s`` had accumulated was noise."""
        self._s = 0.0
        self._prev_s = 0.0

    def carried(self, scale: float) -> "CusumDetector":
        """Baseline carry across a reconfiguration: the healthy iteration
        time changes by a *predictable* ratio (Eq. 1/2 under old vs new
        plan), so instead of re-learning from scratch — which lets a slow
        ramp hide inside every fresh warm-up window — the frozen baseline is
        rescaled by ``scale`` and the accumulated CUSUM evidence is kept
        (``_s`` is in std units, invariant under a common rescale). Falls
        back to a fresh detector if the baseline was never frozen."""
        new = CusumDetector(k=self.k, h=self.h, warmup=self.warmup)
        if self._frozen and scale > 0.0 and math.isfinite(scale):
            new._mean = self._mean * scale
            new._std = self._std * scale
            new._frozen = True
            new._s = self._s
            new._prev_s = self._prev_s
        return new

    def rebaseline(self):
        """Re-learn the healthy baseline (after a reconfiguration)."""
        self._hist = []
        self._s = 0.0
        self._prev_s = 0.0
        self._frozen = False


@dataclass
class SlopeDriftDetector:
    """Windowed least-squares trend test for slow-ramp degradations.

    Fits ``y ~ a + b*t`` over the last ``window`` points and fires when the
    slope is both practically significant (``b`` exceeds ``rel_slope_min`` of
    the window mean per step) and statistically significant (``b / stderr(b)``
    exceeds ``sig``). Complements CUSUM: a ramp spreads its level shift over
    many points, each inside the CUSUM slack, but the trend statistic grows
    with the window. The window is NOT cleared on a fire: while the trend
    persists the detector keeps alarming (each alarm costs only the workload
    filter) so the ramp is re-examined as it deepens — essential because the
    filter releases a validation only once the ramp clears its margin.
    ``rescale`` carries the window across a reconfiguration whose healthy
    time changed by a predicted ratio."""

    window: int = 40
    min_points: int = 12
    sig: float = 4.0  # threshold on the t-like statistic slope/stderr
    rel_slope_min: float = 0.0015  # slope floor, per step, relative to mean
    _pts: list = field(default_factory=list)

    def update(self, x: float) -> bool:
        self._pts.append(float(x))
        if len(self._pts) > self.window:
            self._pts.pop(0)
        n = len(self._pts)
        if n < self.min_points:
            return False
        y = np.asarray(self._pts, dtype=np.float64)
        t = np.arange(n, dtype=np.float64)
        tc = t - t.mean()
        ybar = float(y.mean())
        stt = float((tc * tc).sum())
        b = float((tc * (y - ybar)).sum()) / stt
        if b <= self.rel_slope_min * max(abs(ybar), 1e-12):
            return False
        resid = y - (ybar + b * tc)
        dof = max(n - 2, 1)
        se = math.sqrt(max(float((resid * resid).sum()) / dof, 1e-24) / stt)
        return b / max(se, 1e-12) > self.sig

    def discard_last(self):
        """Drop the last (filtered-benign) point from the trend window."""
        if self._pts:
            self._pts.pop()

    def rescale(self, scale: float):
        """Carry the window across a reconfiguration: every point rescaled by
        the predicted healthy-time ratio, so the trend of the underlying
        degradation survives the plan change."""
        if scale > 0.0 and math.isfinite(scale):
            self._pts = [p * scale for p in self._pts]
        else:
            self._pts = []

    def reset(self):
        self._pts = []
