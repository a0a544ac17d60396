"""ResiHPController: the two-stage detect -> adapt protocol (paper §4).

Wires the Detector (fail-stop heartbeats + workload-aware fail-slow) to the
Scheduler (progressive TP/PP/DP adaptation). Both the discrete-event cluster
simulator (256-GPU experiments) and the real JAX engine (8-device
integration tests) drive this same controller:

    ctl = ResiHPController(scheduler, detector, plan, speeds)
    ...
    rep = ctl.observe_iteration(it, seconds, workload, now)   # fail-slow path
    rep = ctl.poll(now)                                       # fail-stop path
    if rep: adaptation = ctl.adapt(now)                       # new plan

The controller owns the authoritative device-speed view: fail-stop sets a
device's speed to 0, fail-slow to the measured fraction; adapt() feeds that
into Scheduler.adapt and rebaselines the Detector's time series (the healthy
iteration time changes with the plan).

A copy of `repro.core.resihp`, kept whole here, since the port's driver runs
detect -> adapt with it, without importing the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.detector.detector import Detector, FailureReport
from repro_torch.core.scheduler.plan import ParallelPlan
from repro_torch.core.scheduler.scheduler import AdaptationPlan, Scheduler


@dataclass
class ReconfigEvent:
    time: float
    reports: tuple
    adaptation: AdaptationPlan


@dataclass
class ResiHPController:
    scheduler: Scheduler
    detector: Detector
    plan: ParallelPlan
    speeds: dict  # device_id -> normalized throughput (authoritative view)
    pending: list = field(default_factory=list)
    events: list = field(default_factory=list)
    stage_speeds: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.stage_speeds:
            self.stage_speeds = {
                (r, s): 1.0
                for r in range(self.plan.dp)
                for s in range(self.plan.replicas[0].pp)
            }
        self.detector.heartbeat.on_failstop = None  # polled, not pushed

    # ------------------------------------------------------------- detect
    def poll(self, now: float) -> Optional[FailureReport]:
        rep = self.detector.poll_failstop(now)
        if rep:
            for d in rep.devices:
                self.speeds[d] = 0.0
            self.pending.append(rep)
        return rep

    def observe_iteration(self, iteration: int, seconds: float, workload,
                          now: float = 0.0) -> Optional[FailureReport]:
        rep = self.detector.observe_iteration(iteration, seconds, workload, now)
        if rep:
            for dev, speed in rep.devices:
                self.speeds[dev] = float(speed)
            self.pending.append(rep)
        return rep

    def inject_rejoin(self, devices, now: float = 0.0):
        """Repaired devices coming back (the Fig. 14 dynamic scenario)."""
        for d in devices:
            self.speeds[d] = 1.0
        self.pending.append(
            FailureReport("rejoin", tuple(devices), -1, now, detail="devices restored")
        )

    # -------------------------------------------------------------- adapt
    def adapt(self, now: float = 0.0) -> Optional[AdaptationPlan]:
        if not self.pending:
            return None
        reports = tuple(self.pending)
        self.pending = []
        failed = {d for d, v in self.speeds.items() if v <= 0.0}
        adaptation = self.scheduler.adapt(self.plan, self.speeds, failed=failed)
        self.plan = adaptation.plan
        self.stage_speeds = adaptation.stage_speeds
        self.detector.rebaseline()
        self.events.append(ReconfigEvent(now, reports, adaptation))
        return adaptation

    # ------------------------------------------------------------ queries
    @property
    def total_detection_overhead_s(self) -> float:
        return self.detector.overhead_s

    @property
    def total_plan_overhead_s(self) -> float:
        return sum(e.adaptation.plan_overhead_s for e in self.events)
