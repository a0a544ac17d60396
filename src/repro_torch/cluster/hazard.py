"""Per-device hazard models: age-dependent MTTF instead of a global rate.

The paper's §8.1 injection protocol (and everything built on it up to now)
draws failures from a *global* Poisson process: every device is equally
likely to be the next victim, and a device that failed three times is as
likely to fail again as one that never did. Fleet-scale reliability reports
(ByteDance's robust-training infrastructure retrospective, the SPARe/ElasWave
line of work) say otherwise: failure intensity is a *per-device* function of
age, part quality and repair history. This module provides both halves of
that story:

* the **ground-truth side** — :class:`HazardModel`, a seeded per-device
  Weibull renewal process with covariates (initial age, "lemon" parts with a
  shorter characteristic life, wear-out per imperfect repair). It replaces
  the global-rate victim pool inside
  :class:`~repro_torch.cluster.scenarios.PoissonFailures` when
  ``hazard=HazardConfig(...)`` is set (default **off** — the golden trace is
  untouched) and backs the ``aging_fleet`` / ``lemon_devices`` /
  ``infant_mortality`` scenario families;
* the **observational side** — :class:`HazardEstimator`, a Gamma-prior
  empirical rate estimate over a device's
  :class:`~repro_torch.core.detector.lifecycle.FailureHistory`. The system never
  sees the ground-truth model; what it *can* see is each device's detected
  failure count and exposure time, and the estimator turns that into the
  per-device risk scores that drive hazard-keyed quarantine
  (:class:`~repro_torch.core.detector.lifecycle.LifecycleManager`) and risk-aware
  placement (``Scheduler.adapt(device_risk=...)``). The default-off policy
  switch is ``ResiHPPolicy(hazard=HazardPolicyConfig(...))``.

Hazard math
-----------
A device with characteristic life ``lam`` (seconds), Weibull shape ``k`` and
rate multiplier ``m`` (wear) has cumulative hazard ``H(a) = m * (a/lam)**k``
at age ``a``. ``k > 1`` models wear-out (old parts fail more), ``k < 1``
infant mortality (fresh parts fail more), ``k = 1`` is the memoryless
exponential — with no covariates that special case is statistically the
global-rate process the repo always had. Sampling uses the standard
inverse-transform for a conditional renewal: given survival to age ``a`` and
``E ~ Exp(1)``, the next failure age solves ``H(x) - H(a) = E``, i.e.
``x = lam * (E/m + (a/lam)**k) ** (1/k)``. Everything is driven by the
scenario's derived RNG, so the same ``(topology, seed)`` compiles to a
byte-identical timeline like every other scenario.

A copy of `repro.cluster.hazard`, kept whole here, without importing the
JAX package.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "HazardConfig", "HazardModel", "HazardPolicyConfig", "HazardEstimator",
    "DomainPolicyConfig", "DomainEstimator",
]


# ============================================================ ground truth
@dataclass(frozen=True)
class HazardConfig:
    """Ground-truth fleet hazard parameters (scenario side, default-off).

    ``mttf_s`` is the Weibull characteristic life of a *median* device; a
    ``lemon_frac`` fraction of devices (seeded, anonymous) get
    ``mttf_s / lemon_factor`` instead — the bad-part tail every large fleet
    has. ``age_spread_s`` draws each device's initial age uniformly from
    ``[0, age_spread_s]`` so a wear-out fleet (``shape > 1``) is
    heterogeneous from the first second. ``wear_per_repair`` multiplies a
    device's hazard rate after every repair (imperfect repair: a swapped
    part helps, a reseated cable does not).
    """

    mttf_s: float = 400.0
    shape: float = 1.0  # Weibull k: >1 wear-out, <1 infant mortality
    age_spread_s: float = 0.0
    lemon_frac: float = 0.0
    lemon_factor: float = 8.0
    wear_per_repair: float = 1.0
    # -------- topology covariates (default-off: per-device independence) --
    # A seeded ``bad_domain_frac`` fraction of failure domains (PDUs by
    # default — see ``ClusterTopology.nodes_per_pdu``) go *bad*: every
    # resident device's hazard rate is multiplied by ``bad_domain_factor``.
    # This is the correlated-failure regime fleet retrospectives report —
    # a browned-out PDU takes out devices by rack, not independently.
    bad_domain_frac: float = 0.0
    bad_domain_factor: float = 1.0
    domain: str = "pdu"  # grouping: 'pdu' | 'switch' | 'node'

    def __post_init__(self):
        if self.mttf_s <= 0 or self.shape <= 0:
            raise ValueError("HazardConfig needs mttf_s > 0 and shape > 0")
        if not (0.0 <= self.lemon_frac <= 1.0):
            raise ValueError("lemon_frac must be in [0, 1]")
        if self.lemon_factor < 1.0 or self.wear_per_repair < 1.0:
            raise ValueError("lemon_factor / wear_per_repair must be >= 1")
        if not (0.0 <= self.bad_domain_frac <= 1.0):
            raise ValueError("bad_domain_frac must be in [0, 1]")
        if self.bad_domain_factor < 1.0:
            raise ValueError("bad_domain_factor must be >= 1")
        if self.domain not in ("pdu", "switch", "node", "rack"):
            raise ValueError(f"unknown domain kind {self.domain!r}")

    def __repr__(self):
        # HazardConfig reprs are embedded in scenario reprs, which key the
        # DSL's derived RNG streams: with the domain covariates unset this
        # must reproduce the pre-domain dataclass repr byte-for-byte so
        # existing hazard families (aging_fleet, lemon_devices, ...) keep
        # their compiled timelines.
        s = (f"HazardConfig(mttf_s={self.mttf_s!r}, shape={self.shape!r}, "
             f"age_spread_s={self.age_spread_s!r}, "
             f"lemon_frac={self.lemon_frac!r}, "
             f"lemon_factor={self.lemon_factor!r}, "
             f"wear_per_repair={self.wear_per_repair!r}")
        if self.bad_domain_frac > 0.0:
            s += (f", bad_domain_frac={self.bad_domain_frac!r}, "
                  f"bad_domain_factor={self.bad_domain_factor!r}, "
                  f"domain={self.domain!r}")
        return s + ")"


class HazardModel:
    """Per-device Weibull renewal process over a fleet of ``n_devices``.

    Construction consumes exactly two vectorized draws from ``rng`` (lemon
    assignment, initial ages) — plus one more, gated on
    ``cfg.bad_domain_frac > 0``, for bad-domain assignment — so scenario
    compilation stays deterministic and composition-stable under the DSL's
    derived-RNG contract (covariates off ⇒ identical draw sequence to the
    pre-domain model).

    With the domain covariates on, ``topo`` (a
    :class:`~repro_torch.cluster.registry.ClusterTopology`) supplies the device →
    domain map; a seeded ``bad_domain_frac`` fraction of domains (at least
    one, same guarantee as the lemon tail) multiplies every resident
    device's hazard rate by ``bad_domain_factor``.
    """

    def __init__(self, cfg: HazardConfig, n_devices: int,
                 rng: np.random.Generator, topo=None):
        self.cfg = cfg
        self.n_devices = int(n_devices)
        u = rng.uniform(size=self.n_devices)
        lemons = u < cfg.lemon_frac
        if cfg.lemon_frac > 0.0 and self.n_devices and not lemons.any():
            # a configured lemon tail always exists: without this, small
            # fleets / unlucky seeds draw zero lemons and the family's
            # repeat-offender dynamics silently vanish
            lemons[int(np.argmin(u))] = True
        self.scale = np.where(lemons, cfg.mttf_s / cfg.lemon_factor,
                              cfg.mttf_s)
        self.age0 = (rng.uniform(0.0, cfg.age_spread_s, size=self.n_devices)
                     if cfg.age_spread_s > 0.0 else np.zeros(self.n_devices))
        self.mult = np.ones(self.n_devices)
        self.lemons = lemons
        self.bad_domains = frozenset()
        if cfg.bad_domain_frac > 0.0 and self.n_devices:
            if topo is None:
                raise ValueError(
                    "HazardConfig.bad_domain_frac > 0 needs a ClusterTopology"
                    " for the device -> domain map (pass topo=)")
            dom = np.array([topo.domain_of(d, cfg.domain)
                            for d in range(self.n_devices)], dtype=np.intp)
            n_dom = int(dom.max()) + 1
            v = rng.uniform(size=n_dom)
            bad = v < cfg.bad_domain_frac
            if not bad.any():
                # same always-at-least-one guarantee as the lemon tail
                bad[int(np.argmin(v))] = True
            self.bad_domains = frozenset(np.nonzero(bad)[0].tolist())
            self.mult[bad[dom]] *= cfg.bad_domain_factor

    # --------------------------------------------------------------- query
    def cumulative_hazard(self, device: int, age_s: float) -> float:
        return float(self.mult[device]
                     * (max(age_s, 0.0) / self.scale[device]) ** self.cfg.shape)

    def rate(self, device: int, t: float) -> float:
        """Instantaneous hazard (failures/s) at simulated time ``t``."""
        lam, k = float(self.scale[device]), self.cfg.shape
        a = max(float(self.age0[device]) + t, 1e-12)
        return float(self.mult[device]) * (k / lam) * (a / lam) ** (k - 1.0)

    # ------------------------------------------------------------ sampling
    def sample_next(self, device: int, t: float,
                    rng: np.random.Generator) -> float:
        """Absolute time of the device's next failure, conditioned on it
        being alive (and just repaired / fresh) at time ``t``."""
        e = float(rng.exponential(1.0))
        lam, k = float(self.scale[device]), self.cfg.shape
        m = float(self.mult[device])
        a = float(self.age0[device]) + t
        x = lam * (e / m + (a / lam) ** k) ** (1.0 / k)
        return t + max(x - a, 1e-9)

    def record_repair(self, device: int):
        self.mult[device] *= self.cfg.wear_per_repair


def hazard_event_times(model: HazardModel, rng: np.random.Generator, *,
                       t_start: float, t_end: float, mttr: Optional[float],
                       renewal: bool, max_events: int):
    """Drive the fleet's competing per-device renewal processes into a flat
    ``(t_fail, device, t_repair | None)`` sequence for scenario compilation.

    Each device holds one pending next-failure sample in a min-heap; firing a
    failure optionally samples an exponential repair (``mttr``) and — in
    renewal mode — re-arms the device from its repair time with the wear
    multiplier applied. Deterministic: draws happen in device-id order at
    init and in firing order afterwards.
    """
    heap = []
    for d in range(model.n_devices):
        heapq.heappush(heap, (model.sample_next(d, t_start, rng), d))
    out = []
    while heap and len(out) < max_events:
        t, d = heapq.heappop(heap)
        if t >= t_end:
            break
        t_rep = None
        if mttr is not None:
            t_rep = t + float(rng.exponential(mttr))
            if renewal:
                model.record_repair(d)
                heapq.heappush(heap, (model.sample_next(d, t_rep, rng), d))
        out.append((t, d, t_rep))
    return out


# ========================================================== observational
@dataclass(frozen=True)
class HazardPolicyConfig:
    """Default-off policy switch for the hazard-*aware* system behaviours
    (``ResiHPPolicy(hazard=...)``; ``hazard=True`` for these defaults).
    Requires the failure-lifecycle subsystem (it owns the per-device
    ``FailureHistory`` the estimator reads); enabling ``hazard`` without
    ``lifecycle`` turns the default ``LifecycleConfig`` on too.

    * ``quarantine`` — quarantine entry/backoff keyed on the *estimated*
      per-device risk instead of the raw fail-stop flap counter: a device
      whose risk score (``1 + n_recent/prior_failures``, fail-slows
      included — a part that keeps coming back degraded is as much a lemon
      as one that dies) reaches ``rate_threshold_ratio`` quarantines on
      rejoin, for a duration that scales with how far above threshold it
      sits (capped at the lifecycle's ``backoff_max_s``).
    * ``planning`` — feed the estimated rates into ``Scheduler.adapt`` as
      ``device_risk``: among equal-throughput choices the planner prefers
      low-hazard devices for TP membership and standby pull-in (risk-aware
      placement; ties only, Eq. 4 still decides throughput).
    """

    prior_failures: float = 0.5  # Gamma prior pseudo-events: each in-window
    # failure adds 1/prior_failures to the risk score
    prior_time_s: float = 400.0  # Gamma prior pseudo-exposure (seconds) —
    # only scales the absolute ``rate()`` view; the decision paths use the
    # exposure-free ``risk()`` score, where it cancels
    rate_threshold_ratio: float = 4.0  # risk score at/above => quarantine
    # (with prior_failures=0.5: 2 in-window failures)
    # recency window (validated in __post_init__ together with the priors —
    # a zero prior would divide-by-zero deep in the decide loop otherwise):
    # only failures inside the last ``window_s`` seconds
    # count as evidence (with exposure capped at the window), so a device
    # whose failure burst is *over* decays back below the quarantine
    # threshold instead of being benched on stale history. ``inf`` => all
    # history counts.
    window_s: float = 60.0
    quarantine: bool = True
    planning: bool = True
    # per-device MTTF priors (default None => the fleet-wide prior for
    # everyone, byte-identical to the pre-prior estimator): a tuple of
    # ``(device_id, mttf_s)`` pairs, fit offline by
    # ``tools/fit_credit.py --priors`` from observed sweep histories. A
    # device with a fitted MTTF shorter than ``prior_time_s`` scores
    # proportionally riskier *before* any fresh in-session evidence — the
    # fleet's known lemons start on the back foot.
    priors: Optional[tuple] = None

    def __post_init__(self):
        if self.prior_failures <= 0 or self.prior_time_s <= 0:
            raise ValueError("HazardPolicyConfig priors must be > 0")
        if self.rate_threshold_ratio < 1.0:
            raise ValueError("rate_threshold_ratio must be >= 1 (1.0 "
                             "quarantines every rejoining device)")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if self.priors is not None:
            norm = []
            for item in (self.priors.items()
                         if isinstance(self.priors, dict) else self.priors):
                d, mttf = item
                if mttf <= 0:
                    raise ValueError(
                        f"per-device MTTF prior must be > 0 (device {d})")
                norm.append((int(d), float(mttf)))
            # frozen dataclass: normalize to a canonical hashable form
            object.__setattr__(self, "priors", tuple(sorted(norm)))


class HazardEstimator:
    """Posterior-mean per-device failure-rate estimate from observed history:
    ``(prior_failures + n_detected) / (prior_time_s + exposure)`` — the
    Gamma-Exponential conjugate update, shrunk toward the fleet prior so a
    single unlucky failure does not brand a device a lemon."""

    def __init__(self, cfg: HazardPolicyConfig):
        self.cfg = cfg
        # device -> fitted MTTF (empty when no per-device priors are set)
        self._prior_mttf = dict(cfg.priors or ())

    @property
    def prior_rate(self) -> float:
        return self.cfg.prior_failures / self.cfg.prior_time_s

    def _prior_factor(self, history) -> float:
        """Per-device prior multiplier on the risk score: the fleet prior
        exposure over the device's fitted MTTF (1.0 when no prior is set —
        the exposure-free score is untouched)."""
        if not self._prior_mttf or history is None:
            return 1.0
        mttf = self._prior_mttf.get(history.device)
        return self.cfg.prior_time_s / mttf if mttf else 1.0

    def _recent_failures(self, history, now: float) -> int:
        """Failures inside the recency window — fail-stops *and* fail-slows:
        a part that keeps coming back degraded is as much a lemon as one
        that dies."""
        if history is None:
            return 0
        t0 = now - self.cfg.window_s
        return (sum(1 for t in history.fail_stops if t >= t0)
                + sum(1 for t, _ in history.fail_slows if t >= t0))

    def rate(self, history, now: float) -> float:
        """Posterior-mean absolute rate (failures/s), for introspection and
        absolute-threshold consumers: recent events over windowed exposure,
        shrunk by the Gamma prior. The decision paths below do NOT use this
        directly — they use :meth:`risk`, whose same-exposure baseline
        cancels the denominator."""
        exposure = max(min(now, self.cfg.window_s), 0.0)
        return ((self.cfg.prior_failures + self._recent_failures(history, now))
                / (self.cfg.prior_time_s + exposure))

    def risk(self, history, now: float) -> float:
        """Risk score for the planner: the device's posterior rate over the
        same-exposure baseline. The exposure terms cancel algebraically, so
        this is exactly ``1 + n_recent / prior_failures`` — a clean device
        (or one whose burst aged out of the window) scores 1.0, never below,
        and each in-window failure adds ``1/prior_failures``. Exposure-free
        by construction: the score depends only on recent failure count, not
        on when in the session it is evaluated. With per-device MTTF priors
        (``cfg.priors``) the score is further multiplied by
        ``prior_time_s / mttf_device`` — a fitted lemon scores above 1.0
        even before fresh evidence."""
        base = (1.0 + self._recent_failures(history, now)
                / self.cfg.prior_failures)
        return base * self._prior_factor(history)

    def should_quarantine(self, history, now: float) -> bool:
        return self.risk(history, now) >= self.cfg.rate_threshold_ratio

    def backoff_s(self, history, now: float, *, base_s: float,
                  max_s: float, level: int, factor: float) -> float:
        """Risk-keyed quarantine duration: the base backoff scaled by how
        far the device's risk score sits above the quarantine threshold,
        escalated per unserved quarantine level exactly like the flap-counter
        policy, capped at ``max_s``."""
        ratio = self.risk(history, now) / self.cfg.rate_threshold_ratio
        dur = base_s * max(ratio, 1.0) * factor ** max(level - 1, 0)
        return min(dur, max_s)


# ------------------------------------------------- pooled (domain) side
@dataclass(frozen=True)
class DomainPolicyConfig:
    """Default-off policy switch for *domain-level* failure awareness
    (``ResiHPPolicy(domains=...)``; ``domains=True`` for these defaults).
    Implies the hazard estimator (and therefore the lifecycle subsystem):
    the pooled estimator reads the same per-device ``FailureHistory``
    records, aggregated by the topology's domain map.

    * ``domain`` — which correlation domain to pool over ('pdu' | 'switch'
      | 'node'); PDUs are the default because brownouts are the canonical
      correlated killer.
    * ``quarantine`` — when a domain's pooled risk crosses
      ``rate_threshold_ratio`` *and* at least ``min_devices`` distinct
      resident devices failed inside the window, every resident device is
      excluded from placement (the whole rack is benched before its third
      device fails). Purely functional in ``now``: the window sliding past
      the burst readmits the domain with no extra state.
    * ``spread`` — feed the pooled risk to ``Scheduler.adapt`` as
      per-device risk (max-merged with the per-device estimate) so
      equal-throughput placement ties break away from hot domains, and TP
      groups / standbys straddle domains.
    * ``hold_s`` — minimum bench time once a domain trips. Domain evidence
      goes quiet the moment the bench works (a standby device's throttling
      never shows up in iteration time), so a purely window-functional
      quarantine flaps: trip, evidence ages out, readmit, re-detect,
      re-trip — each flip a full replan with migrations. The hold keeps a
      tripped domain benched for ``hold_s`` after its last supporting
      evidence, trading a bounded capacity tax for churn immunity.
    * ``restart`` — a :class:`~repro_torch.checkpoint.RestartCostModel` (or
      ``True`` for its defaults, ``None`` to disable): lets the policy
      charge restart-from-checkpoint instead of live migration whenever the
      modeled restart cost undercuts the live adaptation cost.
    """

    domain: str = "pdu"
    prior_failures: float = 0.5  # same normalization as HazardPolicyConfig
    window_s: float = 60.0
    rate_threshold_ratio: float = 4.0
    min_devices: int = 2  # distinct recent-failing residents to quarantine
    quarantine: bool = True
    spread: bool = True
    hold_s: float = 90.0  # bench dwell after the last supporting evidence
    restart: object = True

    def __post_init__(self):
        if self.domain not in ("pdu", "switch", "node", "rack"):
            raise ValueError(f"unknown domain kind {self.domain!r}")
        if self.prior_failures <= 0:
            raise ValueError("prior_failures must be > 0")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if self.rate_threshold_ratio < 1.0:
            raise ValueError("rate_threshold_ratio must be >= 1")
        if self.min_devices < 1:
            raise ValueError("min_devices must be >= 1")
        if self.hold_s < 0:
            raise ValueError("hold_s must be >= 0")


class DomainEstimator:
    """Pooled sibling of :class:`HazardEstimator`: the same exposure-free
    risk score, computed over the union of a domain's resident
    ``FailureHistory`` records — ``1 + pooled_recent / prior_failures``.
    On a single-device domain this reduces *exactly* to the per-device
    estimator's score (same prior, same window, same fail-stop+fail-slow
    evidence), so domain pooling is a strict generalization, not a second
    calibration.

    Quarantine additionally requires ``min_devices`` distinct recent-failing
    residents: two failures on one device are that device's problem (the
    per-device estimator already benches it); two failures on two devices of
    the same rack are the rack's problem — that correlation is the only
    signal this class adds."""

    def __init__(self, cfg: DomainPolicyConfig):
        self.cfg = cfg

    def _recent(self, histories, now: float):
        """Pooled in-window failure count + the distinct devices involved."""
        t0 = now - self.cfg.window_s
        n, devs = 0, set()
        for h in histories:
            if h is None:
                continue
            c = (sum(1 for t in h.fail_stops if t >= t0)
                 + sum(1 for t, _ in h.fail_slows if t >= t0))
            if c:
                n += c
                devs.add(h.device)
        return n, devs

    def risk(self, histories, now: float) -> float:
        n, _ = self._recent(histories, now)
        return 1.0 + n / self.cfg.prior_failures

    def should_quarantine(self, histories, now: float) -> bool:
        n, devs = self._recent(histories, now)
        return (len(devs) >= self.cfg.min_devices
                and 1.0 + n / self.cfg.prior_failures
                >= self.cfg.rate_threshold_ratio)


def expected_failures(model: HazardModel, horizon_s: float) -> float:
    """Fleet-level expected failure count over ``[0, horizon]`` (no repairs):
    sum of per-device cumulative-hazard increments. Used by tests and for
    sizing scenario parameters against a target event budget."""
    tot = 0.0
    for d in range(model.n_devices):
        a0 = float(model.age0[d])
        tot += (model.cumulative_hazard(d, a0 + horizon_s)
                - model.cumulative_hazard(d, a0))
    return tot
