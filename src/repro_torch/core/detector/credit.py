"""Unified per-device credit score: one learned health scalar behind
quarantine, admission and placement (ROADMAP open item 3).

The policy stack grew four parallel, independently hand-thresholded opinions
about each device — the flap counter (:class:`LifecycleManager`), the slope
drift test (with its hand-tuned 10% ``drift_filter_threshold``), the
Gamma-posterior hazard estimate (:class:`HazardEstimator`) and the rejoin
probe — so a device can be simultaneously "suspect" to one signal and
"healthy" to the others, and every new scenario family means re-tuning four
knobs. This module collapses them into a single scalar per device::

    credit = clamp(1 - alpha * risk_excess
                     - beta  * flap_pressure
                     - gamma * drift_excess
                     - delta * domain_elevation,  0, 1)

where every signal is derived from the *existing* evidence stores (the
lifecycle's :class:`FailureHistory` records and the hazard estimator's
windowed risk score — no new bookkeeping):

* ``risk_excess`` — the hazard estimator's exposure-free risk score minus
  its 1.0 baseline (``n_recent / prior_failures``): recent failures of any
  kind, decaying as the window slides past them;
* ``flap_pressure`` — recent fail-stops over the flap threshold (the raw
  flap counter, normalized so pressure 1.0 is the legacy quarantine trip);
* ``drift_excess`` — the worst in-window detected fail-slow shortfall
  (``1 - measured speed``): a device currently running below peak;
* ``domain_elevation`` — in-window failures pooled over the device's
  failure-domain *siblings*: correlated evidence that the neighborhood, not
  the part, is the problem.

All four weights are non-negative, so credit is monotone: any signal
worsening can only lower it. The weights plus the decision band edges are
**fit offline** against sweep outcomes by ``tools/fit_credit.py`` and
checked into ``src/repro_torch/configs/credit_fitted.json`` —
:func:`fitted_credit_config` loads them (falling back to the in-code
defaults when the artifact is absent).

Band semantics (the whole decision surface keys on one scalar):

* ``credit <  quarantine_band``  — quarantine on rejoin, backoff scaled by
  the shortfall below the band (``quarantine_band=0`` never quarantines);
* ``credit <  probe_band``      — admit through the rejoin micro-benchmark;
  under the credit switch the probe runs *asynchronously* (ElasWave-style:
  the probe occupies the still-idle rejoining device, not the training
  job), so the measured speed enters beliefs one probe-latency later and no
  global time is charged;
* ``credit >= probe_band``      — direct admit at full belief, no probe;
* ``credit <  ntp_band``        — the device is vetoed from NTP shrink-shard
  retention (excluded instead): nonuniform widths are for *trustworthy*
  stragglers (thermal capping), not for parts whose history says the
  slowness is a symptom;
* placement — ``Scheduler.adapt(device_credit=...)`` breaks equal-throughput
  ties toward high-credit devices (superseding the raw ``device_risk``
  view), and the restart-vs-adapt decision discounts the live-adaptation
  threshold by the plan's mean credit (a low-credit fleet is likely to be
  interrupted again before a checkpoint restore pays off).

The model is maintained incrementally and array-backed (``.arr`` beside
``BeliefArray``, bumped ``version``) so the fast engine can read the whole
fleet's credit in one gather without per-device Python loops. Default-off:
``ResiHPPolicy(credit=True | CreditConfig(...))``; off is byte-identical to
every pre-credit path.

A copy of `repro.core.detector.credit`, kept whole here, without importing
the JAX package; ``credit_fitted.json`` is a byte-equal copy of the
reference's.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["CreditConfig", "CreditModel", "CreditStats",
           "fitted_credit_config", "FITTED_CONFIG_PATH"]

FITTED_CONFIG_PATH = (Path(__file__).resolve().parents[2]
                      / "configs" / "credit_fitted.json")

# the fields tools/fit_credit.py searches over (and the only keys
# credit_fitted.json may carry) — everything else is fixed structure
FIT_FIELDS = ("alpha", "beta", "gamma", "delta", "quarantine_band",
              "probe_band", "ntp_band", "drift_filter_threshold",
              "validation_debounce_s", "window_s")


@dataclass(frozen=True)
class CreditConfig:
    """Credit-model weights, decision bands and signal windows.

    The first block is the fit surface (``tools/fit_credit.py``); defaults
    are the checked-in fitted values' fallback, used when
    ``credit_fitted.json`` is absent. The second block is fixed structure:
    signal windows deliberately shared with the estimators that own the
    evidence (hazard window for risk, flap window for flaps) so one scalar
    summarizes the same facts the legacy thresholds saw.
    """

    # ---- fitted surface --------------------------------------------------
    alpha: float = 0.05   # weight per risk_excess unit (1 unit = 1/prior ev.)
    beta: float = 0.25    # weight per flap_pressure unit (1.0 = legacy trip)
    gamma: float = 0.30   # weight per drift_excess unit (1.0 = dead slow)
    delta: float = 0.05   # weight per domain_elevation unit
    quarantine_band: float = 0.05  # credit strictly below => quarantine
    probe_band: float = 0.85       # credit at/above => direct admit, no probe
    # credit strictly below => vetoed from NTP shrink-shard retention
    # (0.0 disables the veto — every straggler stays shrink-eligible)
    ntp_band: float = 0.75
    # the drift test's validation margin, retired as a hand-tuned constant:
    # under the credit switch this fitted value replaces the lifecycle's
    # literal 0.10 (which remains the credit-off default). 1.0 is a fit
    # outcome with teeth: no shortfall can clear a 100% margin, so the
    # simulator skips installing the drift stack entirely and slowness
    # reaches the planner only through the gamma term
    drift_filter_threshold: float = 0.10
    # the validation debounce, the other hand-tuned lifecycle constant the
    # fit retires: armed slowness validations wait this long before firing.
    # The surface is sharp — storm families want sub-second reaction while
    # ramp families want the full legacy hold — so it is fit, not tuned
    # (4.0 stays the credit-off default via LifecycleConfig)
    validation_debounce_s: float = 4.0
    # risk/domain evidence recency (no-hazard fallback; with an estimator
    # attached its own window governs risk). Fit, not fixed: the window is
    # the veto's memory — how long a domain burst keeps its survivors
    # veto-listed. Too long and a staggered storm's veto outlives the storm
    # (retention denied after devices recovered); too short and a mass
    # simultaneous burst clears before the pivotal shrink decision
    window_s: float = 60.0
    # ---- fixed structure -------------------------------------------------
    flap_window_s: float = 200.0   # matches LifecycleConfig.flap_window_s
    flap_threshold: int = 2        # matches LifecycleConfig.flap_threshold
    drift_window_s: float = 90.0   # fail-slow evidence recency
    prior_failures: float = 0.5    # risk normalization (matches hazard prior)
    domain: str = "pdu"            # sibling pooling for domain_elevation
    backoff_scale: float = 4.0     # backoff multiplier per unit band shortfall
    # probation re-checks: a device admitted at a measured speed below full
    # keeps being re-probed (free, async — same justification as admission)
    # every this-many seconds until belief matches truth. Without it a
    # transiently-throttled rejoiner is benched on a stale measurement
    # forever: nothing ever re-measures a device the planner stopped using
    # (0 disables probation)
    probation_recheck_s: float = 20.0
    # ---- gates -----------------------------------------------------------
    planning: bool = True          # feed credit to Scheduler.adapt placement
    quarantine: bool = True        # band-keyed quarantine entry/backoff
    admission: bool = True         # band-keyed probe/direct admission
    restart_weighting: bool = True  # group credit discounts restart threshold

    def __post_init__(self):
        for name in ("alpha", "beta", "gamma", "delta"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"CreditConfig.{name} must be >= 0 "
                                 "(credit must stay monotone)")
        if not (0.0 <= self.quarantine_band <= self.probe_band <= 1.0):
            raise ValueError("need 0 <= quarantine_band <= probe_band <= 1")
        if not (0.0 <= self.ntp_band <= 1.0):
            raise ValueError("ntp_band must be in [0, 1]")
        if not (0.0 < self.drift_filter_threshold <= 1.0):
            raise ValueError("drift_filter_threshold must be in (0, 1]")
        if self.validation_debounce_s < 0.0:
            raise ValueError("validation_debounce_s must be >= 0")
        if (self.flap_threshold < 1 or self.flap_window_s <= 0
                or self.drift_window_s <= 0 or self.window_s <= 0
                or self.prior_failures <= 0):
            raise ValueError("credit signal windows/priors must be positive")
        if self.domain not in ("pdu", "switch", "node", "rack"):
            raise ValueError(f"unknown domain kind {self.domain!r}")
        if self.backoff_scale < 0:
            raise ValueError("backoff_scale must be >= 0")
        if self.probation_recheck_s < 0.0:
            raise ValueError("probation_recheck_s must be >= 0")


@dataclass
class CreditStats:
    """Credit-path counters, kept *separate* from :class:`LifecycleStats`
    (whose ``as_dict`` feeds every pre-credit sweep cell's JSON — growing it
    would break old-cell byte identity). Surfaced only on credit rows."""

    direct_admits: int = 0      # credit >= probe_band: no probe at all
    async_admissions: int = 0   # probed off the critical path
    quarantines: int = 0        # band-keyed quarantine entries
    ntp_vetoes: int = 0         # low-credit devices the planner barred from
    # shrink-shard retention (Scheduler bumps this on uncached plans)
    probation_corrections: int = 0  # re-probes that moved a stale belief
    # (the device recovered — or degraded further — since admission)

    def as_dict(self):
        return dict(self.__dict__)


class CreditModel:
    """Per-device credit over the lifecycle's :class:`FailureHistory`
    records. Pure bookkeeping — no simulator imports; the caller supplies
    ``now`` and the histories dict it already owns.

    ``arr`` is the dense per-device mirror (1.0 = full credit) and
    ``version`` bumps whenever any score changes — the same array-backed
    contract :class:`BeliefArray` gives the fast engine, so vectorized
    consumers can gate on the version instead of re-reading the dict."""

    def __init__(self, cfg: CreditConfig, n_devices: int, *,
                 hazard: Optional[object] = None,
                 domain_members: Optional[dict] = None):
        self.cfg = cfg
        self.hazard = hazard  # duck-typed HazardEstimator (risk()) or None
        self.n_devices = int(n_devices)
        self.arr = np.ones(self.n_devices, dtype=np.float64)
        self.version = 0
        self.stats = CreditStats()
        self._last: dict = {}
        # device -> tuple of same-domain sibling ids (self excluded)
        self._siblings: dict = {}
        if domain_members:
            for members in domain_members.values():
                for d in members:
                    self._siblings[d] = tuple(m for m in members if m != d)

    # ------------------------------------------------------------- signals
    def _risk_excess(self, h, now: float) -> float:
        if self.hazard is not None:
            return max(self.hazard.risk(h, now) - 1.0, 0.0)
        t0 = now - self.cfg.window_s
        n = (sum(1 for t in h.fail_stops if t >= t0)
             + sum(1 for t, _ in h.fail_slows if t >= t0))
        return n / self.cfg.prior_failures

    def _flap_pressure(self, h, now: float) -> float:
        return (h.recent_failstops(now, self.cfg.flap_window_s)
                / self.cfg.flap_threshold)

    def _drift_excess(self, h, now: float) -> float:
        t0 = now - self.cfg.drift_window_s
        worst = 0.0
        for t, speed in h.fail_slows:
            if t >= t0:
                worst = max(worst, 1.0 - speed)
        return max(worst, 0.0)

    def _domain_elevation(self, device: int, now: float, histories) -> float:
        sibs = self._siblings.get(device)
        if not sibs or histories is None:
            return 0.0
        t0 = now - self.cfg.window_s
        n = 0
        for s in sibs:
            h = histories.get(s)
            if h is None:
                continue
            # fail-STOPS only: elevation models correlated failure bursts
            # (a PDU trip takes out neighbours); pooling slow events here
            # would double-count slowness the gamma term already carries and
            # poison the NTP veto for merely-throttled fleets
            n += sum(1 for t in h.fail_stops if t >= t0)
        return n / self.cfg.prior_failures

    # -------------------------------------------------------------- scores
    def credit_of(self, h, now: float, histories=None) -> float:
        """Credit scalar for one device's history (1.0 = full trust)."""
        cfg = self.cfg
        c = (1.0
             - cfg.alpha * self._risk_excess(h, now)
             - cfg.beta * self._flap_pressure(h, now)
             - cfg.gamma * self._drift_excess(h, now)
             - cfg.delta * self._domain_elevation(h.device, now, histories))
        return min(max(c, 0.0), 1.0)

    def scores(self, histories: dict, now: float) -> dict:
        """Non-unity credit scores for every device with failure history
        (unknown devices are implied full credit — same sparse convention as
        ``risk_scores``), refreshing the dense mirror and bumping
        ``version`` when anything moved."""
        out = {}
        for d, h in histories.items():
            c = self.credit_of(h, now, histories)
            if c != 1.0:
                out[d] = c
        if out != self._last:
            self.arr[:] = 1.0
            for d, c in out.items():
                self.arr[d] = c
            self._last = dict(out)
            self.version += 1
        return out


def fitted_credit_config(path: Optional[Path] = None) -> CreditConfig:
    """The fitted weights (``credit_fitted.json``'s ``fitted`` block) as a
    :class:`CreditConfig`; in-code defaults when the artifact is missing.
    Unknown keys are rejected — the artifact may only carry the fit
    surface, never silently rewire structure."""
    p = Path(path) if path is not None else FITTED_CONFIG_PATH
    if not p.exists():
        return CreditConfig()
    payload = json.loads(p.read_text())
    params = payload.get("fitted", {})
    bad = set(params) - set(FIT_FIELDS)
    if bad:
        raise ValueError(f"credit_fitted.json carries non-fit keys: {sorted(bad)}")
    return CreditConfig(**params)
