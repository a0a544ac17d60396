"""Per-device failure-lifecycle tracking: flap quarantine, ramp-aware drift
policy and rejoin admission (the post-§5/§6 gap the PR-1 scenario families
exposed).

ResiHP's Detector/Scheduler loop treats failures as one-shot: every flap of
the same device is re-detected, re-validated and re-planned from scratch; a
device that rejoins is believed healthy (speed 1.0) regardless of its actual
state; and a slowly-ramping straggler hides inside the fresh CUSUM warm-up
window that every reconfiguration opens. Production fleets (ByteDance's
failure-lifecycle reports; ElasWave's re-admission probing) show the fix is
per-device failure *history*. This module provides it:

* **Flap quarantine** — a device whose fail-stop count inside
  ``flap_window_s`` reaches ``flap_threshold`` is quarantined on rejoin with
  exponential backoff (``backoff_base_s * backoff_factor**level``, capped).
  While quarantined the device stays out of the Scheduler's plans (no
  replanning, no reconfiguration charge, no detector rebaseline) and the
  Detector never pays validation for its flaps.
* **Rejoin admission** — an ElasWave-style micro-benchmark probe runs when a
  device rejoins (and when a quarantine expires): the system's belief enters
  at the *measured* speed, not 1.0. A probe that still measures (near-)zero
  extends the quarantine instead of readmitting.
* **Ramp-aware drift** — the config gates the Detector's slope-drift test and
  baseline carry across ``rebaseline()`` (see
  :class:`~repro_torch.core.detector.changepoint.SlopeDriftDetector` and
  ``CusumDetector.carried``); the lifecycle manager only carries the flag,
  the Detector owns the mechanics.
* **Hazard-keyed quarantine** (PR 4) — when the manager is handed a hazard
  estimator (duck-typed: ``risk``/``should_quarantine``/``backoff_s`` over
  a device's :class:`FailureHistory`; see
  :class:`repro_torch.cluster.hazard.HazardEstimator` — injected by the caller so
  this module stays import-clean of the cluster layer), quarantine *entry*
  keys on the estimated per-device failure rate instead of the raw fail-stop
  flap counter — so a part that keeps coming back degraded (fail-slow
  repeats, which the flap counter never sees) is quarantined too — and the
  backoff *duration* scales with how far above the quarantine threshold the
  estimate sits. ``risk_scores()`` exposes the same estimates to the
  Scheduler for risk-aware placement.
* **Validation as a fail-stop path** — ``cfg.validation_failstop`` lets a
  validation pass report dead devices (speed 0) directly: a device that died
  just before a validation micro-benchmark ran no longer waits for the
  heartbeat timeout (and its NCCL-stall charge) to enter system beliefs.
  The simulator owns the mechanics (see ``TrainingSim._validate``).

Lifecycle states per device::

    healthy -> suspect -> quarantined -> probing -> readmitted
       ^         |             |            |          |
       |         +---- rejoin (admitted) ---+----------+
       +------------------- probe measures healthy ----+

``suspect`` marks a device with failure history that is currently believed
degraded or down; ``readmitted`` marks one that returned through a probe.

Everything here is pure policy + bookkeeping (no jax, no simulator imports):
the cluster simulator supplies ``probe_fn`` (the micro-benchmark) and charges
``probe_cost_s`` to simulated time; the default-off switch is
``ResiHPPolicy(lifecycle=...)``.

A copy of `repro.core.detector.lifecycle`, kept whole here, without
importing the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBING = "probing"
READMITTED = "readmitted"

STATES = (HEALTHY, SUSPECT, QUARANTINED, PROBING, READMITTED)


@dataclass
class LifecycleConfig:
    """Tunables for the failure-lifecycle policies. Each policy has its own
    gate so ablations can enable them independently."""

    quarantine: bool = True  # flap quarantine with exponential backoff
    drift: bool = True  # slope-drift test + baseline carry across rebaseline
    admission: bool = True  # micro-benchmark probe on rejoin
    # detector-side redundant-validation skipping: change points raised this
    # soon after a heartbeat fail-stop report are explained by the known
    # failure, not worth a validation pass (a carried baseline has no fresh
    # warm-up window to absorb the stall/replan transient)
    failstop_suppress_s: float = 10.0
    # hold a filter-passing alarm this long before paying validation; dropped
    # if a heartbeat fail-stop report lands first (the alarm was the dying
    # device's pre-detection stall). Sized to the heartbeat detection window
    # (interval * miss_threshold) plus margin.
    validation_debounce_s: float = 4.0
    # validation margin for drift alarms (trend evidence justifies a gate
    # tighter than the 25% rule — migration hides most of a ramp's level)
    drift_filter_threshold: float = 0.10
    flap_window_s: float = 200.0  # fail-stops inside this window count as flaps
    flap_threshold: int = 2  # this many recent fail-stops => quarantine
    backoff_base_s: float = 40.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 1200.0
    probe_cost_s: float = 0.5  # micro-benchmark wall time per probe
    readmit_speed_floor: float = 0.05  # probe below this => still failed
    # validation doubles as a fail-stop path: a validation pass that finds a
    # dead device reports it immediately instead of leaving it to time out
    # its heartbeats (and pay the NCCL-stall charge) — ROADMAP open item
    validation_failstop: bool = True


@dataclass
class FailureHistory:
    """Persistent per-device record threaded through detection/scheduling."""

    device: int
    state: str = HEALTHY
    fail_stops: list = field(default_factory=list)  # detection times
    fail_slows: list = field(default_factory=list)  # (time, measured speed)
    rejoins: list = field(default_factory=list)  # admitted-rejoin times
    quarantine_until: float = 0.0
    quarantine_level: int = 0  # backoff exponent (resets on clean readmit)
    last_probe_speed: float = 1.0

    def recent_failstops(self, now: float, window: float) -> int:
        return sum(1 for t in self.fail_stops if now - t <= window)


@dataclass(frozen=True)
class RejoinDecision:
    """Outcome of ``on_rejoin`` / a quarantine-release probe."""

    device: int
    admit: bool
    speed: float = 1.0  # belief speed to enter on admit
    probe_cost_s: float = 0.0  # charged to simulated time by the caller
    state: str = READMITTED
    until: float = 0.0  # quarantine expiry when not admitted


@dataclass
class LifecycleStats:
    quarantines: int = 0
    rejoins_deferred: int = 0  # rejoin events absorbed by an active quarantine
    probes: int = 0
    readmissions: int = 0
    degraded_admissions: int = 0  # probe measured < 1.0 on an admitted rejoin

    def as_dict(self):
        return dict(self.__dict__)


@dataclass
class LifecycleManager:
    """Owns every device's :class:`FailureHistory` and decides quarantine /
    admission. ``probe_fn(device) -> measured speed`` is the micro-benchmark
    (ground-truth lookup in the simulator, mirroring Greyhound's validation
    pass); its cost is returned in each decision for the caller to charge."""

    cfg: LifecycleConfig = field(default_factory=LifecycleConfig)
    probe_fn: Optional[Callable] = None
    # duck-typed hazard estimator (repro_torch.cluster.hazard.HazardEstimator or
    # anything with risk/should_quarantine/backoff_s and a cfg carrying
    # ``quarantine``/``planning`` gates). None => flap-counter policy.
    hazard: Optional[object] = None
    # unified credit model (repro_torch.core.detector.credit.CreditModel, attached
    # by the simulator when the ``credit`` switch is on). When present, the
    # decision chain rekeys on credit bands: quarantine entry is
    # ``credit < quarantine_band`` (strict — band 0 never quarantines),
    # backoff scales with the shortfall below the band, and admission is
    # banded (``credit >= probe_band`` admits directly with no probe at
    # all). None => the hazard / flap-counter chain, byte-identical.
    credit: Optional[object] = None
    histories: dict = field(default_factory=dict)  # device -> FailureHistory
    stats: LifecycleStats = field(default_factory=LifecycleStats)

    def history(self, device: int) -> FailureHistory:
        h = self.histories.get(device)
        if h is None:
            h = self.histories[device] = FailureHistory(device)
        return h

    # ------------------------------------------------------------ recording
    def record_failstop(self, device: int, now: float):
        h = self.history(device)
        h.fail_stops.append(now)
        if h.state != QUARANTINED:
            h.state = SUSPECT

    def record_failslow(self, device: int, speed: float, now: float):
        h = self.history(device)
        h.fail_slows.append((now, float(speed)))
        if h.state != QUARANTINED:
            h.state = SUSPECT

    # ------------------------------------------------------------- rejoins
    def _probe(self, h: FailureHistory) -> float:
        self.stats.probes += 1
        h.last_probe_speed = float(self.probe_fn(h.device)) if self.probe_fn else 1.0
        return h.last_probe_speed

    def _hazard_quarantine(self) -> bool:
        return self.hazard is not None and self.hazard.cfg.quarantine

    def _credit_quarantine(self) -> bool:
        return self.credit is not None and self.credit.cfg.quarantine

    def _should_quarantine(self, h: FailureHistory, now: float) -> bool:
        if self._credit_quarantine():
            # band-keyed entry on the unified scalar: strictly below the
            # quarantine band (band 0.0 therefore never quarantines)
            c = self.credit.credit_of(h, now, self.histories)
            return c < self.credit.cfg.quarantine_band
        if self._hazard_quarantine():
            # hazard-keyed entry: the estimated per-device rate (fail-slows
            # included) crossed the quarantine threshold — not "N fail-stops
            # in a window"
            return self.hazard.should_quarantine(h, now)
        return (h.recent_failstops(now, self.cfg.flap_window_s)
                >= self.cfg.flap_threshold)

    def _enter_quarantine(self, h: FailureHistory, now: float) -> RejoinDecision:
        h.quarantine_level += 1
        if self._credit_quarantine():
            # backoff scales with the shortfall below the quarantine band:
            # a device just under the band sits out ~base_s, a zero-credit
            # part sits out up to (1 + scale*band) times longer per level
            ccfg = self.credit.cfg
            c = self.credit.credit_of(h, now, self.histories)
            shortfall = max(ccfg.quarantine_band - c, 0.0)
            dur = min(
                self.cfg.backoff_base_s
                * (1.0 + ccfg.backoff_scale * shortfall)
                * self.cfg.backoff_factor ** (h.quarantine_level - 1),
                self.cfg.backoff_max_s,
            )
            self.credit.stats.quarantines += 1
        elif self._hazard_quarantine():
            dur = self.hazard.backoff_s(
                h, now, base_s=self.cfg.backoff_base_s,
                max_s=self.cfg.backoff_max_s, level=h.quarantine_level,
                factor=self.cfg.backoff_factor)
        else:
            dur = min(
                self.cfg.backoff_base_s
                * self.cfg.backoff_factor ** (h.quarantine_level - 1),
                self.cfg.backoff_max_s,
            )
        h.quarantine_until = now + dur
        h.state = QUARANTINED
        self.stats.quarantines += 1
        return RejoinDecision(h.device, admit=False, speed=0.0,
                              state=QUARANTINED, until=h.quarantine_until)

    def _admit(self, h: FailureHistory, now: float) -> RejoinDecision:
        cost = 0.0
        if (self.credit is not None and self.credit.cfg.admission
                and self.credit.credit_of(h, now, self.histories)
                >= self.credit.cfg.probe_band):
            # banded direct admission: a device whose whole evidence record
            # sums to near-full credit skips the micro-benchmark entirely —
            # belief enters at 1.0 and no probe time exists to charge
            self.credit.stats.direct_admits += 1
            h.state = READMITTED if h.fail_stops or h.fail_slows else HEALTHY
            h.rejoins.append(now)
            h.quarantine_level = 0
            self.stats.readmissions += 1
            return RejoinDecision(h.device, admit=True, speed=1.0,
                                  probe_cost_s=0.0, state=h.state)
        if self.cfg.admission and self.probe_fn is not None:
            h.state = PROBING
            speed = self._probe(h)
            cost = self.cfg.probe_cost_s
            if speed <= self.cfg.readmit_speed_floor:
                # came back dead (or flapped down again before the probe ran)
                if self.cfg.quarantine:
                    dec = self._enter_quarantine(h, now)
                    return RejoinDecision(h.device, admit=False, speed=0.0,
                                          probe_cost_s=cost, state=QUARANTINED,
                                          until=dec.until)
                return RejoinDecision(h.device, admit=False, speed=0.0,
                                      probe_cost_s=cost, state=SUSPECT)
            if speed < 1.0:
                self.stats.degraded_admissions += 1
        else:
            speed = 1.0  # legacy belief: every rejoin is full-health
        h.state = READMITTED if h.fail_stops or h.fail_slows else HEALTHY
        h.rejoins.append(now)
        h.quarantine_level = 0 if speed >= 1.0 else h.quarantine_level
        self.stats.readmissions += 1
        return RejoinDecision(h.device, admit=True, speed=speed,
                              probe_cost_s=cost, state=h.state)

    def on_rejoin(self, device: int, now: float) -> RejoinDecision:
        """A repaired device announced itself. Decide quarantine vs (probed)
        admission. The caller applies the belief/heartbeat effects and
        charges ``probe_cost_s``."""
        h = self.history(device)
        if h.state == QUARANTINED and now < h.quarantine_until:
            # the flapper bounced back while still serving its quarantine
            self.stats.rejoins_deferred += 1
            return RejoinDecision(device, admit=False, speed=0.0,
                                  state=QUARANTINED, until=h.quarantine_until)
        if self.cfg.quarantine and self._should_quarantine(h, now):
            return self._enter_quarantine(h, now)
        return self._admit(h, now)

    # ---------------------------------------------------------- quarantine
    def is_quarantined(self, device: int, now: float) -> bool:
        h = self.histories.get(device)
        return (h is not None and h.state == QUARANTINED
                and now < h.quarantine_until)

    def quarantined(self, now: float) -> frozenset:
        """Devices the Scheduler must keep out of plans right now."""
        return frozenset(
            d for d, h in self.histories.items()
            if h.state == QUARANTINED and now < h.quarantine_until
        )

    def poll_releases(self, now: float) -> list:
        """Expired quarantines: probe each and either readmit (decision with
        ``admit=True`` and the measured speed) or extend the backoff (the
        device is still down — decision with ``admit=False``). The caller
        charges every decision's ``probe_cost_s``."""
        out = []
        for h in self.histories.values():
            if h.state != QUARANTINED or now < h.quarantine_until:
                continue
            speed = self._probe(h)
            cost = self.cfg.probe_cost_s
            if speed <= self.cfg.readmit_speed_floor:
                dec = self._enter_quarantine(h, now)
                out.append(RejoinDecision(h.device, admit=False, speed=0.0,
                                          probe_cost_s=cost, state=QUARANTINED,
                                          until=dec.until))
                continue
            h.state = READMITTED
            h.rejoins.append(now)
            self.stats.readmissions += 1
            if speed >= 1.0:
                h.quarantine_level = 0  # clean full-speed readmit: backoff resets
            else:
                self.stats.degraded_admissions += 1
            # the release probe always runs (quarantine must know the device
            # is back at all); only with admission on does the measured speed
            # seed the belief — otherwise the legacy full-health assumption
            admit_speed = speed if self.cfg.admission else 1.0
            out.append(RejoinDecision(h.device, admit=True, speed=admit_speed,
                                      probe_cost_s=cost, state=READMITTED))
        return out

    # --------------------------------------------------------------- intro
    def states(self) -> dict:
        return {d: h.state for d, h in self.histories.items()}

    def risk_scores(self, now: float) -> dict:
        """Per-device risk view for the Scheduler (``device_risk``): the
        hazard estimator's rate-over-prior ratio for every device with
        failure history (1.0 = fleet baseline; unknown devices are implied
        baseline). Empty when no estimator is attached or planning is off."""
        if self.hazard is None or not self.hazard.cfg.planning:
            return {}
        return {d: self.hazard.risk(h, now)
                for d, h in self.histories.items()}
