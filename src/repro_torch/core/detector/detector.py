"""The ResiHP Detector (paper §5): fail-stop via hierarchical heartbeats,
fail-slow via change-point detection on the iteration-time series with a
workload-aware filter.

Fail-slow pipeline per iteration (paper §5.2):
  1. append observed iteration time to the series; run the change-point
     detector (Greyhound-style proxy signal);
  2. on a change point, *analytically* estimate the expected healthy
     iteration time for the current workload (Eq. 1 micro-batch predictor +
     Eq. 2 DAG critical path, both supplied as `healthy_time_fn`);
  3. if observed > (1 + filter_threshold) * predicted  -> run the expensive
     validation phase (`validate_fn`) to localize degraded devices;
     else -> benign workload fluctuation: drop the point from the series and
     skip validation (this is what kills Greyhound's false alarms).

`workload_filter=False` reproduces Greyhound's behaviour (every change point
pays validation) — the Table 5 baseline.

A copy of `repro.core.detector.detector`, kept here so that the port runs
the Detector on times measured on the card without importing the JAX
package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.detector.changepoint import CusumDetector
from repro_torch.core.detector.heartbeat import HeartbeatMonitor


@dataclass(frozen=True)
class FailureReport:
    kind: str  # 'fail-stop' | 'fail-slow'
    devices: tuple  # device ids; fail-slow entries are (device_id, speed)
    iteration: int
    time: float
    detail: str = ""


@dataclass
class DetectorStats:
    change_points: int = 0
    drift_alarms: int = 0  # change points raised by the slope-drift test
    validations: int = 0
    false_alarms: int = 0
    filtered_benign: int = 0
    suppressed_failstop: int = 0  # alarms explained by a just-detected fail-stop
    missed_filter: int = 0  # filter said benign but a real failure existed
    detections: int = 0
    carried_rebaselines: int = 0  # rebaselines that kept the scaled baseline
    validation_overhead_s: float = 0.0
    filter_overhead_s: float = 0.0

    def as_dict(self):
        return dict(self.__dict__)


@dataclass
class Detector:
    """Owns the fail-stop heartbeat hierarchy and the fail-slow series logic.

    healthy_time_fn(workload) -> predicted healthy iteration seconds.
    validate_fn(iteration) -> list[(device_id, measured_speed)] of degraded
        devices (empty if none). Its cost models Greyhound's validation pass.
    """

    healthy_time_fn: Callable
    validate_fn: Callable
    heartbeat: HeartbeatMonitor = field(default_factory=HeartbeatMonitor)
    workload_filter: bool = True
    filter_threshold: float = 0.25  # the 25% rule
    validation_cost_s: float = 3.0  # paper Table 5: seconds per validation
    filter_cost_s: float = 0.045  # paper Table 5: 34-49 ms per filtered alarm
    changepoint_factory: Callable = CusumDetector
    # failure-lifecycle drift policy (default off = paper behaviour):
    # drift_factory adds a slope/GLR trend test alongside CUSUM so slow ramps
    # fire before completion; carry_baseline keeps the (rescaled) baseline
    # across rebaseline() instead of re-learning from scratch.
    drift_factory: Optional[Callable] = None
    carry_baseline: bool = False
    # cheap per-iteration workload scalar (Eq. 1 sum over micro-batches, no
    # DAG sim): the drift test runs on observed / scalar so workload swings
    # between iterations do not drown a ramp's slope in residual noise
    workload_scalar_fn: Optional[Callable] = None
    # a drift alarm carries trend evidence a workload spike cannot produce,
    # so it validates at a tighter margin than the 25% rule — otherwise the
    # system's own mitigation (progress-aware migration hides most of a slow
    # ramp) keeps the observed time under the 25% gate until long after the
    # ramp completed
    drift_filter_threshold: float = 0.10
    # change points raised this soon after a heartbeat fail-stop report are
    # explained by the known failure (stall + replan transient): skip the
    # redundant validation pass. 0 = off (paper behaviour); the lifecycle
    # policy enables it — a carried baseline has no warm-up window to absorb
    # these transients the way a fresh one accidentally did
    suppress_failstop_s: float = 0.0
    # validation debounce: hold an alarm that passed the filter for this long
    # before paying the validation pass; if a heartbeat fail-stop report
    # arrives in the meantime the alarm was that failure's pre-detection
    # stall and is dropped. Covers the window where a dying device already
    # slows iterations but has not yet missed enough heartbeats. 0 = off.
    validation_debounce_s: float = 0.0
    stats: DetectorStats = field(default_factory=DetectorStats)
    reports: list = field(default_factory=list)

    def __post_init__(self):
        self._cpd = self.changepoint_factory()
        self._drift = self.drift_factory() if self.drift_factory else None
        self._series: list = []
        self._last_failstop_t = -math.inf
        self._pending_val: Optional[tuple] = None  # (iteration, armed_t, obs)

    # ------------------------------------------------------------ fail-stop
    def poll_failstop(self, now: float) -> Optional[FailureReport]:
        newly = self.heartbeat.sweep(now)
        if not newly:
            return None
        rep = FailureReport("fail-stop", tuple(newly), len(self._series), now,
                            detail="heartbeat loss")
        self.reports.append(rep)
        self.stats.detections += 1
        self._last_failstop_t = now
        return rep

    def note_failstop(self, now: float):
        """Record an out-of-band fail-stop detection (a validation pass that
        measured a device dead) so the ``suppress_failstop_s`` window and
        the pending-validation drop arm exactly as they do for
        heartbeat-detected deaths — without this, the stall/replan transient
        of a validation-detected death would charge a second validation and
        count a false alarm."""
        self._last_failstop_t = now

    # ------------------------------------------------------------ fail-slow
    def observe_iteration(self, iteration: int, observed_s: float, workload,
                          now: float = 0.0) -> Optional[FailureReport]:
        """Returns a FailureReport if a fail-slow failure is confirmed."""
        self._series.append(observed_s)
        fired = self._cpd.update(observed_s)
        drift_fired = False
        if self._drift is not None:
            x = observed_s
            if self.workload_scalar_fn is not None:
                x = observed_s / max(self.workload_scalar_fn(workload), 1e-12)
            drift_fired = self._drift.update(x)
        # resolve a debounced alarm AFTER recording this observation, so the
        # series/change-point state never run a point behind on a confirm
        if self._pending_val is not None:
            armed_it, armed_t, armed_obs = self._pending_val
            if self._last_failstop_t >= armed_t:
                # the alarm was the pre-detection stall of a fail-stop the
                # heartbeat hierarchy has since localized: drop it
                self.stats.suppressed_failstop += 1
                self._pending_val = None
            elif now - armed_t >= self.validation_debounce_s:
                self._pending_val = None
                rep = self._run_validation(armed_it, now, armed_obs)
                if rep is not None:
                    return rep
        if drift_fired:
            self.stats.drift_alarms += 1
            fired = True
        if not fired:
            return None
        self.stats.change_points += 1

        if (self.suppress_failstop_s > 0.0
                and now - self._last_failstop_t <= self.suppress_failstop_s):
            # lifecycle: the alarm is explained by a fail-stop the heartbeat
            # hierarchy already localized (stall + replan transient) — a
            # validation pass could only rediscover what is known
            self.stats.suppressed_failstop += 1
            self._discard_last_point(drop_drift=True)
            return None

        if self.workload_filter:
            self.stats.filter_overhead_s += self.filter_cost_s
            predicted = self.healthy_time_fn(workload)
            threshold = (min(self.filter_threshold, self.drift_filter_threshold)
                         if drift_fired else self.filter_threshold)
            if observed_s <= (1.0 + threshold) * predicted:
                # benign workload fluctuation: remove the point, skip
                # validation. The drift window keeps the point — a ramp's
                # early observations are individually benign (that is the
                # point of a ramp) and dropping them would blind the trend
                # test to exactly the failures it exists for.
                self.stats.filtered_benign += 1
                self._discard_last_point(drop_drift=False)
                return None

        if self.validation_debounce_s > 0.0:
            if self._pending_val is None:
                self._pending_val = (iteration, now, observed_s)
            return None

        # validation phase (expensive)
        return self._run_validation(iteration, now, observed_s,
                                    pop_on_false=True)

    def _run_validation(self, iteration: int, now: float, observed_s: float,
                        *, pop_on_false: bool = False
                        ) -> Optional[FailureReport]:
        self.stats.validations += 1
        self.stats.validation_overhead_s += self.validation_cost_s
        degraded = self.validate_fn(iteration)
        if not degraded:
            # a false alarm is removed from the series exactly like a benign
            # point — the change-point state must not keep the contaminated
            # observation either (it previously did: only the series was
            # popped, so spurious alarms perturbed later detection)
            self.stats.false_alarms += 1
            if pop_on_false:
                self._discard_last_point(drop_drift=True)
            else:
                # debounced path: the armed point is buried in the series, so
                # an exact rewind is impossible — but validation just
                # certified every device healthy, which means the accumulated
                # CUSUM/trend evidence is noise; clear it instead
                if hasattr(self._cpd, "clear_evidence"):
                    self._cpd.clear_evidence()
                if self._drift is not None:
                    self._drift.reset()
            return None
        self.stats.detections += 1
        rep = FailureReport("fail-slow", tuple(degraded), iteration, now,
                            detail=f"observed={observed_s:.3f}s")
        self.reports.append(rep)
        return rep

    # -------------------------------------------------------------- control
    def _discard_last_point(self, *, drop_drift: bool):
        """Remove the last observation from the series and the CUSUM state
        (benign/false-alarm points must not contaminate later detection —
        paper §5.2). ``drop_drift`` also removes it from the trend window:
        done for disproved (false-alarm) and fail-stop-explained points, but
        NOT for workload-benign ones, which a slow ramp is made of."""
        self._series.pop()
        if hasattr(self._cpd, "discard_last"):
            self._cpd.discard_last()
        if drop_drift and self._drift is not None:
            self._drift.discard_last()

    def rebaseline(self, scale: Optional[float] = None):
        """Reset the time-series model after a reconfiguration (the healthy
        iteration time changes when the parallel plan changes).

        With the lifecycle drift policy (``carry_baseline=True``) and a
        predicted healthy-time ratio ``scale`` (new plan / old plan), the
        frozen baseline and accumulated evidence are *carried* — rescaled by
        ``scale`` — instead of re-learned: a slow ramp can no longer hide
        inside the fresh warm-up window every reconfiguration used to open.
        """
        if (scale is not None and self.carry_baseline
                and hasattr(self._cpd, "carried")):
            self._cpd = self._cpd.carried(scale)
            if self._drift is not None:
                self._drift.rescale(scale)
            if getattr(self._cpd, "_frozen", False):
                self.stats.carried_rebaselines += 1
        else:
            self._cpd = self.changepoint_factory()
            if self._drift is not None:
                self._drift.reset()
        self._series = []

    @property
    def overhead_s(self) -> float:
        return self.stats.validation_overhead_s + self.stats.filter_overhead_s
