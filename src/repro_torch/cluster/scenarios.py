"""Declarative failure scenarios: a composable DSL that compiles to a seeded,
deterministic :class:`~repro_torch.cluster.events.EventTrace`.

A :class:`FailureScenario` describes *what goes wrong and when* independently
of any simulator instance. ``scenario.compile(topo, seed)`` produces the flat
event timeline; ``TrainingSim.apply_scenario`` feeds it through the single
``apply_events(t)`` hook. Scenarios compose with ``+`` (timelines merge in
time order) and every stochastic generator derives its RNG from
``(seed, scenario-name)`` so a sub-scenario compiles to the same events alone
or inside a composition.

Scenario catalog
----------------
Registered names (``scenarios.get(name, **overrides)``):

======================  ====================================================
name                    models / used by
======================  ====================================================
``fig9_failslow``       one compute fail-slow of tunable severity on a fixed
                        device (paper Fig. 9 weak/medium/severe sweep);
                        ``bench_fig9_failslow``
``fig10_mixed``         alternating fail-stop / medium fail-slow over
                        shuffled distinct devices (paper Fig. 10);
                        ``bench_fig10_mixed``
``fig11_mixed``         the 4-event mixed storm used for the component
                        ablation (paper Fig. 11); ``bench_fig11_ablation``
``fig14_largescale``    256-GPU recurring fail-stop + fail-slow with elastic
                        rejoins on a fixed fractional timeline (paper
                        Fig. 14); ``bench_fig14_largescale``
``table5_failslow``     zero or one fail-slow at a random time/device/
                        severity inside a detection window (paper Table 5
                        false-alarm study); ``bench_table5_false_alarms``
``table6_failstop``     monotonic worker terminations at fixed frequency,
                        capped at half the cluster (paper Table 6);
                        ``bench_table6_failstop``
``example_mixed``       the fixed 6-event mixed storm from
                        ``examples/cluster_failures.py``
``rack_storm``          correlated rack failure: every device of one or more
                        racks fail-stops in a staggered burst, with optional
                        recovery (ByteDance-style correlated infra faults);
                        ``bench_scenarios``
``rack_storm_256``      ``rack_storm`` preset at Fig. 14 scale: two racks
                        lost back-to-back, one rejoining later
``flapping_stragglers`` transient flaps — devices bounce between dead and
                        healthy (NIC resets, thermal throttle-recover
                        cycles) while another straggles; ``bench_scenarios``
``flap_then_recover``   a single device flaps repeatedly then stays healthy
``slow_ramp_mix``       slow-ramp stragglers: several devices degrade
                        gradually (step ramps) to different severities, some
                        recovering — the hardest case for change-point
                        detection; ``bench_scenarios``
``thermal_throttle_fleet`` many mild stragglers at once — a fleet fraction
                        throttles to 0.7–0.9x (thermal/power capping): the
                        shrink-shard (NTP) vs exclusion stress family;
                        ``bench_scenarios``
``poisson_storm``       memoryless background failure process with a
                        fail-stop/fail-slow mix and exponential repair times
                        (MTTF/MTTR fleet model); ``bench_scenarios``
``degraded_rejoins``    devices fail-stop and return *degraded* (reduced
                        speed): the rejoin-admission stress case —
                        lifecycle sweeps in ``bench_scenarios``
``aging_fleet``         per-device Weibull wear-out hazard (old fleet, a
                        lemon tail, imperfect repairs): failures concentrate
                        on the worn/lemon devices and recur —
                        the hazard-aware-policy stress case
                        (``bench_scenarios``)
``lemon_devices``       memoryless per-device hazard dominated by a small
                        lemon tail: a few bad parts fail again and again
                        while the rest of the fleet stays clean
``infant_mortality``    fresh fleet with a decreasing hazard (Weibull
                        k < 1): an early failure burst that quiets down
``pdu_brownout``        a browned-out PDU multiplies every resident
                        device's hazard rate (topology covariates):
                        failures concentrate in one power domain and recur
                        — the domain-aware-policy stress case
                        (``bench_scenarios``)
``switch_degrade``      correlated network degrade: every node under one
                        leaf switch sees link contention together, later
                        restored (flaky uplink); ``bench_scenarios``
``restart_storm``       a fleet fraction fail-stops in one tight burst and
                        mass-rejoins after a downtime, twice — the
                        job-restart regime where checkpoint/restart
                        economics beat live adaptation
                        (``bench_scenarios``)
======================  ====================================================

A copy of `repro.cluster.scenarios`, kept whole here (the mined
``adversarial_*`` timelines included), without importing the JAX package.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from repro_torch.cluster.events import Event, EventTrace, encode_rejoin_speed
from repro_torch.cluster.hazard import HazardConfig, HazardModel, hazard_event_times
from repro_torch.cluster.registry import ClusterTopology

__all__ = [
    "FailureScenario", "Compose", "FailStop", "FailSlow", "TransientFlap",
    "NetworkDegrade", "Rejoin", "MixedFailures", "RandomFailSlow",
    "ThermalThrottleFleet", "PoissonFailures", "CorrelatedRackStorm",
    "CorrelatedSwitchDegrade", "RestartStorm", "TimelineScenario",
    "HazardConfig", "register", "get", "names",
]


# ===================================================================== base
class FailureScenario:
    """Base class: subclasses emit events via :meth:`events`."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def events(self, topo: ClusterTopology, rng: np.random.Generator
               ) -> Iterable[Event]:
        raise NotImplementedError

    def compile(self, topo: ClusterTopology, seed: int = 0) -> EventTrace:
        """Deterministic: same (topo, seed) => byte-identical timeline."""
        return EventTrace(self.events(topo, self._rng(seed)))

    def _rng(self, seed: int) -> np.random.Generator:
        # derive from (seed, name, params): composition does not perturb a
        # child's stream, and two same-class children with different
        # parameters draw independent streams (dataclass repr is stable)
        return np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                      zlib.crc32(self.name.encode()),
                                      zlib.crc32(repr(self).encode())])

    def __add__(self, other: "FailureScenario") -> "Compose":
        return Compose([self, other])

    def _ev(self, t, kind, target=-1, value=0.0) -> Event:
        return Event(float(t), kind, int(target), float(value), self.name)


@dataclass
class Compose(FailureScenario):
    """Merge child timelines in time order; children compile independently."""
    children: Sequence[FailureScenario]

    def compile(self, topo: ClusterTopology, seed: int = 0) -> EventTrace:
        out = EventTrace()
        for c in self.children:
            out = out.merge(c.compile(topo, seed))
        return out

    def events(self, topo, rng):  # pragma: no cover - compile() is overridden
        raise RuntimeError("Compose compiles via children")

    def __add__(self, other: FailureScenario) -> "Compose":
        return Compose([*self.children, other])


# =============================================================== primitives
@dataclass
class FailStop(FailureScenario):
    """Terminate a device, a whole node, or a whole rack at time ``at``."""
    at: float
    device: Optional[int] = None
    node: Optional[int] = None
    rack: Optional[int] = None  # alias for node (rack == heartbeat domain)

    def events(self, topo, rng):
        node = self.node if self.node is not None else self.rack
        if (self.device is None) == (node is None):
            raise ValueError("FailStop needs exactly one of device / node|rack")
        if self.device is not None:
            yield self._ev(self.at, "fail-stop", self.device)
        else:
            yield self._ev(self.at, "fail-stop-node", node)


@dataclass
class FailSlow(FailureScenario):
    """Degrade a device to ``severity`` x peak at ``at``; optionally ramp the
    degradation in steps over ``ramp`` seconds (thermal-throttle model) and
    recover after ``duration`` seconds."""
    device: int
    severity: float
    at: float
    duration: Optional[float] = None
    ramp: float = 0.0
    ramp_steps: int = 4

    def events(self, topo, rng):
        if self.ramp > 0.0 and self.ramp_steps > 1:
            for i in range(1, self.ramp_steps + 1):
                frac = i / self.ramp_steps
                speed = 1.0 + (self.severity - 1.0) * frac
                t = self.at + self.ramp * (i - 1) / self.ramp_steps
                yield self._ev(t, "fail-slow", self.device, speed)
        else:
            yield self._ev(self.at, "fail-slow", self.device, self.severity)
        if self.duration is not None:
            yield self._ev(self.at + self.duration, "rejoin", self.device)


@dataclass
class TransientFlap(FailureScenario):
    """A device bounces: dead for ``down_time``, healthy for ``up_time``,
    ``n_flaps`` times (NIC reset / kernel-driver hiccup model).
    ``recover_speed < 1.0`` makes every bounce-back degraded (the part is
    going bad) — the rejoin-admission stress case."""
    device: int
    at: float
    n_flaps: int = 3
    down_time: float = 4.0
    up_time: float = 10.0
    recover_speed: float = 1.0

    def events(self, topo, rng):
        t = self.at
        v = encode_rejoin_speed(self.recover_speed)
        for _ in range(self.n_flaps):
            yield self._ev(t, "fail-stop", self.device)
            yield self._ev(t + self.down_time, "rejoin", self.device, v)
            t += self.down_time + self.up_time


@dataclass
class NetworkDegrade(FailureScenario):
    """Bandwidth contention on a node's links: communication share of each
    resident device stretches by 1/``link_scale``; after ``duration`` the
    contention clears (network component only — co-located fail-stop/
    fail-slow victims are untouched)."""
    node: int
    link_scale: float
    at: float
    duration: Optional[float] = None

    def events(self, topo, rng):
        yield self._ev(self.at, "net-degrade", self.node, self.link_scale)
        if self.duration is not None:
            yield self._ev(self.at + self.duration, "net-restore", self.node)


@dataclass
class Rejoin(FailureScenario):
    """Repair a device and announce it to the system (elastic rejoin,
    ElasWave-style); ``speed < 1.0`` = the device returns degraded."""
    device: int
    at: float
    speed: float = 1.0

    def events(self, topo, rng):
        yield self._ev(self.at, "rejoin", self.device,
                       encode_rejoin_speed(self.speed))


# ======================================================= stochastic storms
@dataclass
class MixedFailures(FailureScenario):
    """``n_events`` alternating fail-stop / fail-slow hits on shuffled
    distinct devices, evenly spread over ``span`` (Fig. 10/11 storm)."""
    span: float
    n_events: int = 6
    severity: float = 0.45
    start: str = "stop"  # which kind goes first

    def events(self, topo, rng):
        devices = rng.permutation(topo.n_devices)
        first_stop = self.start == "stop"
        for i in range(self.n_events):
            t = self.span * (i + 1) / (self.n_events + 1)
            d = int(devices[i])
            if (i % 2 == 0) == first_stop:
                yield self._ev(t, "fail-stop", d)
            else:
                yield self._ev(t, "fail-slow", d, self.severity)


@dataclass
class MonotonicFailStops(FailureScenario):
    """``n_failures`` permanent worker terminations at fixed frequency over
    ``span``, never beyond half the cluster (Table 6 protocol)."""
    span: float
    n_failures: int

    def events(self, topo, rng):
        devices = rng.permutation(topo.n_devices)
        victims = devices[: min(self.n_failures, topo.n_devices // 2)]
        for i, d in enumerate(victims):
            t = self.span * (i + 1) / (len(victims) + 1)
            yield self._ev(t, "fail-stop", int(d))


@dataclass
class RandomFailSlow(FailureScenario):
    """One fail-slow at a random time inside ``window``, random device,
    severity drawn from ``severities`` (Table 5 injection protocol)."""
    window: tuple
    severities: tuple = (0.3, 0.45, 0.6)

    def events(self, topo, rng):
        lo, hi = self.window
        t = float(rng.uniform(lo, max(hi, lo + 1e-9)))
        d = int(rng.integers(0, topo.n_devices))
        sev = float(rng.choice(list(self.severities)))
        yield self._ev(t, "fail-slow", d, sev)


@dataclass
class ThermalThrottleFleet(FailureScenario):
    """Many *mild* stragglers at once: a ``frac`` share of the fleet throttles
    to a severity drawn from ``severity`` (0.7–0.9 = thermal/power capping,
    not hardware faults), at staggered times inside ``window * span``.

    The stress case for the adaptation axis choice: every affected TP group
    keeps running, so exclusion-style planning either drags the whole group
    to the straggler's rate (k * min p) or throws a barely-degraded device
    away — while shrink-shard (NTP widths ∝ p_i) recovers ~sum(p_i) per
    group. With ``recover_after`` set, devices cool down and return to full
    speed (a second ramp of replans back to uniform widths)."""
    span: float
    frac: float = 0.3
    severity: tuple = (0.7, 0.9)
    window: tuple = (0.08, 0.55)
    recover_after: Optional[float] = None  # seconds of throttling, if any

    def events(self, topo, rng):
        n = max(1, int(round(self.frac * topo.n_devices)))
        devices = rng.permutation(topo.n_devices)[:n]
        lo, hi = self.window
        times = rng.uniform(lo * self.span, hi * self.span, size=n)
        sevs = rng.uniform(self.severity[0], self.severity[1], size=n)
        for i in range(n):
            d = int(devices[i])
            yield self._ev(float(times[i]), "fail-slow", d, float(sevs[i]))
            if self.recover_after is not None:
                yield self._ev(float(times[i]) + self.recover_after,
                               "rejoin", d)


@dataclass
class PoissonFailures(FailureScenario):
    """Memoryless background failure process: exponential inter-arrivals at
    ``rate`` events per second over [``t_start``, ``t_end``), each event
    fail-stop with probability ``mix`` else fail-slow with severity drawn
    uniformly from ``severity``; repaired (elastic rejoin) after an
    exponential repair time of mean ``mttr`` when set.

    Two victim-selection modes:

    * **distinct-device** (``renewal=False``, the default) — victims come
      from a seeded permutation and each device is hit at most once per
      compiled timeline. This matches the paper's §8.1 injection protocol
      (a bounded number of distinct faults per session) but understates
      long sessions, where nothing stops a repaired GPU from failing again.
    * **renewal process** (``renewal=True``) — a device that has completed
      its exponential repair (``mttr``) re-enters the victim pool, so the
      same device can fail, rejoin and fail again, approximating a
      per-device MTTF/MTTR renewal process (the fleet model in the
      ByteDance-scale reliability literature). Without ``mttr`` there are
      no repairs, so the two modes emit identical event kinds.

    Both modes are deterministic for a fixed (topology, seed).

    ``hazard=HazardConfig(...)`` (default **off**: the behaviour above is
    byte-identical to every pre-hazard release) replaces the global-rate
    victim pool with per-device age-dependent hazard processes
    (:class:`~repro_torch.cluster.hazard.HazardModel`): inter-arrival times and
    victim identity both come from the fleet's competing Weibull renewals,
    so failures concentrate on old/lemon/worn devices and — with
    ``renewal=True`` — recur on them. ``rate`` is ignored in hazard mode
    (the per-device scales set the intensity); ``mix``/``severity``/
    ``mttr``/``max_events``/``renewal`` keep their meanings.
    """
    rate: float
    t_end: float
    t_start: float = 0.0
    mix: float = 0.5  # P(fail-stop); 1-mix => fail-slow
    severity: tuple = (0.3, 0.6)
    mttr: Optional[float] = None
    max_events: int = 64
    renewal: bool = False
    hazard: Optional[HazardConfig] = None

    def __repr__(self):
        # the derived-RNG stream key is crc32(repr(self)): with ``hazard``
        # unset the repr must stay byte-identical to the pre-hazard
        # dataclass repr, or every existing PoissonFailures timeline would
        # silently recompile differently across releases. A set ``hazard``
        # appends itself, so distinct hazard configs keep distinct streams.
        s = (f"PoissonFailures(rate={self.rate!r}, t_end={self.t_end!r}, "
             f"t_start={self.t_start!r}, mix={self.mix!r}, "
             f"severity={self.severity!r}, mttr={self.mttr!r}, "
             f"max_events={self.max_events!r}, renewal={self.renewal!r}")
        if self.hazard is not None:
            s += f", hazard={self.hazard!r}"
        return s + ")"

    def events(self, topo, rng):
        if self.hazard is not None:
            yield from self._hazard_events(topo, rng)
            return
        t, emitted = self.t_start, 0
        pool = list(rng.permutation(topo.n_devices))
        down: list = []  # (repair-complete time, device) — renewal mode
        while emitted < self.max_events:
            t += float(rng.exponential(1.0 / max(self.rate, 1e-12)))
            if t >= self.t_end:
                break
            if self.renewal and down:
                # repaired devices rejoin the victim pool (renewal process)
                back = sorted(e for e in down if e[0] <= t)
                if back:
                    down = [e for e in down if e[0] > t]
                    pool.extend(d for _, d in back)
            if not pool:
                if self.renewal and down:
                    continue  # everything is mid-repair; arrival hits nothing
                break  # distinct devices exhausted: no double-kill
            d = int(pool.pop(0))
            if float(rng.uniform()) < self.mix:
                yield self._ev(t, "fail-stop", d)
            else:
                sev = float(rng.uniform(*self.severity))
                yield self._ev(t, "fail-slow", d, sev)
            if self.mttr is not None:
                dt = float(rng.exponential(self.mttr))
                yield self._ev(t + dt, "rejoin", d)
                if self.renewal:
                    down.append((t + dt, d))
            emitted += 1

    def _hazard_events(self, topo, rng):
        """Per-device hazard mode: the fleet's competing Weibull renewal
        processes pick both the times and the victims. Draw order is fixed
        (model init, then event times in firing order, then per-event
        kind/severity), so compilation stays byte-deterministic."""
        model = HazardModel(self.hazard, topo.n_devices, rng, topo=topo)
        fails = hazard_event_times(
            model, rng, t_start=self.t_start, t_end=self.t_end,
            mttr=self.mttr, renewal=self.renewal, max_events=self.max_events)
        for t, d, t_rep in fails:
            if float(rng.uniform()) < self.mix:
                yield self._ev(t, "fail-stop", d)
            else:
                sev = float(rng.uniform(*self.severity))
                yield self._ev(t, "fail-slow", d, sev)
            if t_rep is not None:
                yield self._ev(t_rep, "rejoin", d)


@dataclass
class CorrelatedRackStorm(FailureScenario):
    """Correlated infrastructure fault: every device of ``n_racks`` racks
    (random distinct racks unless ``racks`` pins them) fails in a staggered
    burst — PDU/ToR-switch loss takes out co-located devices together.
    ``kind`` picks fail-stop or fail-slow; ``recover_after`` rejoins the
    whole rack (power restored)."""
    at: float
    n_racks: int = 1
    racks: Optional[Sequence[int]] = None
    kind: str = "fail-stop"
    severity: float = 0.4  # only for kind == "fail-slow"
    stagger: float = 0.5
    recover_after: Optional[float] = None

    def events(self, topo, rng):
        racks = (list(self.racks) if self.racks is not None
                 else [int(r) for r in
                       rng.permutation(topo.n_nodes)[: self.n_racks]])
        for r in racks:
            devs = [d for d in range(topo.n_devices) if topo.node_of(d) == r]
            for j, d in enumerate(devs):
                t = self.at + j * self.stagger
                if self.kind == "fail-stop":
                    yield self._ev(t, "fail-stop", d)
                else:
                    yield self._ev(t, "fail-slow", d, self.severity)
                if self.recover_after is not None:
                    yield self._ev(self.at + self.recover_after + j * self.stagger,
                                   "rejoin", d)


@dataclass
class CorrelatedSwitchDegrade(FailureScenario):
    """Correlated network fault: every node under ``n_switches`` leaf
    switches (random distinct switches unless ``switches`` pins them —
    domain map: ``ClusterTopology.nodes_per_switch``) sees link contention
    together in a staggered onset — the flaky-uplink signature where a
    whole switch domain degrades at once rather than one node at a time.
    ``recover_after`` clears the contention (uplink failed over)."""
    at: float
    n_switches: int = 1
    switches: Optional[Sequence[int]] = None
    link_scale: float = 0.35
    stagger: float = 0.5
    recover_after: Optional[float] = None

    def events(self, topo, rng):
        sws = (list(self.switches) if self.switches is not None
               else [int(s) for s in
                     rng.permutation(topo.n_switches)[: self.n_switches]])
        for s in sws:
            for j, node in enumerate(topo.domain_nodes("switch", s)):
                t = self.at + j * self.stagger
                yield self._ev(t, "net-degrade", node, self.link_scale)
                if self.recover_after is not None:
                    yield self._ev(
                        self.at + self.recover_after + j * self.stagger,
                        "net-restore", node)


@dataclass
class RestartStorm(FailureScenario):
    """Job-restart storm: a seeded ``frac`` fraction of the fleet
    fail-stops in one tight staggered burst (the mass-exit signature of a
    job-level restart or a rolling infra intervention) and mass-rejoins
    ``downtime`` later — optionally repeating every ``period`` seconds for
    ``n_storms`` rounds. The scenario where restart-from-checkpoint
    economics matter: adaptation churns through a cliff of simultaneous
    losses that a checkpoint restore would absorb in one charge."""
    at: float
    frac: float = 0.25
    downtime: float = 10.0
    stagger: float = 0.25
    n_storms: int = 1
    period: float = 60.0

    def events(self, topo, rng):
        for k in range(self.n_storms):
            t0 = self.at + k * self.period
            n = max(1, int(round(self.frac * topo.n_devices)))
            victims = sorted(int(d) for d in
                             rng.permutation(topo.n_devices)[:n])
            for j, d in enumerate(victims):
                yield self._ev(t0 + j * self.stagger, "fail-stop", d)
                yield self._ev(t0 + self.downtime + j * self.stagger,
                               "rejoin", d)


@dataclass
class TimelineScenario(FailureScenario):
    """Fixed fractional timeline scaled by ``span``: entries are
    ``(frac, kind, target[, value])`` with targets as indices into a seeded
    device permutation when ``permute`` (Fig. 14 protocol) or literal device
    ids otherwise."""
    span: float
    timeline: Sequence[tuple]
    permute: bool = True
    label: str = "TimelineScenario"

    @property
    def name(self) -> str:
        return self.label

    def events(self, topo, rng):
        devs = list(rng.permutation(topo.n_devices)) if self.permute else None
        for entry in self.timeline:
            frac, kind = entry[0], entry[1]
            target = int(devs[entry[2]]) if devs is not None else int(entry[2])
            value = float(entry[3]) if len(entry) > 3 else 0.0
            yield self._ev(frac * self.span, kind, target, value)


# ================================================================= registry
_REGISTRY: dict = {}


def register(name: str) -> Callable:
    def deco(factory: Callable) -> Callable:
        _REGISTRY[name] = factory
        return factory
    return deco


def get(name: str, **overrides) -> FailureScenario:
    """Instantiate a named scenario; ``overrides`` go to its factory."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; known: {names()}")
    return _REGISTRY[name](**overrides)


def names() -> list:
    return sorted(_REGISTRY)


# ------------------------------------------------- paper-figure scenarios
@register("fig9_failslow")
def _fig9(device: int = 5, factor: float = 0.42, at: float = 12.0,
          **kw) -> FailureScenario:
    return FailSlow(device=device, severity=factor, at=at, **kw)


@register("fig10_mixed")
def _fig10(span: float = 240.0, n_events: int = 6, severity: float = 0.45,
           ) -> FailureScenario:
    return MixedFailures(span=span, n_events=n_events, severity=severity)


@register("fig11_mixed")
def _fig11(span: float = 200.0, severity: float = 0.45) -> FailureScenario:
    return MixedFailures(span=span, n_events=4, severity=severity)


_FIG14_TIMELINE = (
    (0.10, "fail-stop", 0),
    (0.22, "fail-slow", 1, 0.45),
    (0.34, "fail-stop", 2),
    (0.45, "rejoin", 0),
    (0.55, "fail-slow", 3, 0.3),
    (0.66, "fail-stop", 4),
    (0.75, "rejoin", 2),
    (0.85, "fail-slow", 5, 0.55),
)


@register("fig14_largescale")
def _fig14(span: float = 192.0) -> FailureScenario:
    return TimelineScenario(span=span, timeline=_FIG14_TIMELINE,
                            label="fig14_largescale")


@register("table5_failslow")
def _table5(window: tuple = (30.0, 60.0),
            severities: tuple = (0.3, 0.45, 0.6)) -> FailureScenario:
    return RandomFailSlow(window=window, severities=severities)


@register("table6_failstop")
def _table6(span: float = 320.0, n_failures: int = 8) -> FailureScenario:
    return MonotonicFailStops(span=span, n_failures=n_failures)


_EXAMPLE_TIMELINE = (
    (15.0, "fail-stop", 37),
    (35.0, "fail-slow", 101, 0.45),
    (55.0, "fail-stop", 5),
    (75.0, "fail-slow", 182, 0.3),
    (95.0, "fail-stop", 201),
    (115.0, "fail-slow", 66, 0.5),
)


@register("example_mixed")
def _example(span: float = 1.0) -> FailureScenario:
    # literal device ids, absolute times (span=1): the quickstart storm
    return TimelineScenario(span=span, timeline=_EXAMPLE_TIMELINE,
                            permute=False, label="example_mixed")


# --------------------------------------------- new scenario families (PR 1)
@register("rack_storm")
def _rack_storm(at: float = 20.0, n_racks: int = 1, stagger: float = 0.5,
                recover_after: Optional[float] = None) -> FailureScenario:
    return CorrelatedRackStorm(at=at, n_racks=n_racks, stagger=stagger,
                               recover_after=recover_after)


@register("rack_storm_256")
def _rack_storm_256(span: float = 160.0) -> FailureScenario:
    # two racks lost back-to-back; the first comes back (power restored)
    return (CorrelatedRackStorm(at=0.15 * span, racks=[1], stagger=0.25,
                                recover_after=0.45 * span)
            + CorrelatedRackStorm(at=0.35 * span, racks=[5], stagger=0.25))


@register("flap_then_recover")
def _flap_then_recover(device: int = 5, at: float = 15.0, n_flaps: int = 3,
                       down_time: float = 4.0, up_time: float = 12.0,
                       ) -> FailureScenario:
    return TransientFlap(device=device, at=at, n_flaps=n_flaps,
                         down_time=down_time, up_time=up_time)


@register("flapping_stragglers")
def _flapping_stragglers(span: float = 160.0,
                         devices: Sequence[int] = (3, 12, 7)
                         ) -> FailureScenario:
    # two flappers in different racks plus one persistent mid straggler;
    # `devices` lets small-topology harnesses (engine parity at 8 devices)
    # keep the victims in range now that apply_scenario validates targets
    return Compose([
        TransientFlap(device=devices[0], at=0.10 * span, n_flaps=3,
                      down_time=0.02 * span, up_time=0.08 * span),
        TransientFlap(device=devices[1], at=0.30 * span, n_flaps=2,
                      down_time=0.03 * span, up_time=0.10 * span),
        FailSlow(device=devices[2], severity=0.55, at=0.55 * span),
    ])


@register("slow_ramp_mix")
def _slow_ramp_mix(span: float = 160.0,
                   devices: Sequence[int] = (2, 9, 14)) -> FailureScenario:
    # gradual degradations of different depths; the shallow one recovers
    # (`devices` override: see flapping_stragglers)
    return Compose([
        FailSlow(device=devices[0], severity=0.7, at=0.10 * span,
                 ramp=0.15 * span, ramp_steps=4, duration=0.45 * span),
        FailSlow(device=devices[1], severity=0.45, at=0.35 * span,
                 ramp=0.20 * span, ramp_steps=5),
        FailSlow(device=devices[2], severity=0.3, at=0.65 * span,
                 ramp=0.10 * span, ramp_steps=3),
    ])


@register("degraded_rejoins")
def _degraded_rejoins(span: float = 160.0,
                      recover_speed: float = 0.6) -> FailureScenario:
    # devices die and come back *degraded*: the belief gap rejoin admission
    # closes — without a probe the system schedules them as full-health
    return Compose([
        FailStop(at=0.10 * span, device=2),
        Rejoin(device=2, at=0.30 * span, speed=recover_speed),
        FailStop(at=0.45 * span, device=11),
        Rejoin(device=11, at=0.60 * span, speed=recover_speed),
    ])


@register("thermal_throttle_fleet")
def _thermal_throttle_fleet(span: float = 160.0, frac: float = 0.3,
                            severity: tuple = (0.7, 0.9),
                            recover_after: Optional[float] = None,
                            ) -> FailureScenario:
    # many mild stragglers at once (fleet-wide thermal/power capping): the
    # scenario family where shrink-shard (NTP) should dominate exclusion
    return ThermalThrottleFleet(span=span, frac=frac, severity=severity,
                                recover_after=recover_after)


@register("poisson_storm")
def _poisson_storm(rate: float = 0.05, t_end: float = 160.0, mix: float = 0.5,
                   mttr: Optional[float] = 40.0,
                   renewal: bool = False) -> FailureScenario:
    return PoissonFailures(rate=rate, t_end=t_end, mix=mix, mttr=mttr,
                           renewal=renewal)


# ------------------------------------------- per-device hazard families (PR 4)
@register("aging_fleet")
def _aging_fleet(span: float = 160.0, mix: float = 0.1,
                 max_events: int = 64) -> FailureScenario:
    # worn fleet (Weibull k=3, ages spread over 2 spans) with a lemon tail
    # and imperfect repairs: failures recur on the same few bad devices for
    # the whole span — the hazard-aware quarantine/placement stress case.
    # Mostly fail-slow (mix=0.1, the wear-out signature: thermal throttling
    # and ECC-retirement slowdowns, not crashes), so the fail-stop flap
    # counter is blind to the repeats while the hazard estimator is not.
    return PoissonFailures(
        rate=0.0, t_end=span, mix=mix, mttr=0.06 * span, renewal=True,
        max_events=max_events, severity=(0.25, 0.5),
        hazard=HazardConfig(mttf_s=6.0 * span, shape=3.0,
                            age_spread_s=2.0 * span, lemon_frac=0.08,
                            lemon_factor=10.0, wear_per_repair=1.5))


@register("lemon_devices")
def _lemon_devices(span: float = 160.0, lemon_frac: float = 0.08,
                   max_events: int = 24) -> FailureScenario:
    # memoryless per-device hazard dominated by a small lemon tail: a few
    # bad parts fail over and over while the rest of the fleet stays clean
    return PoissonFailures(
        rate=0.0, t_end=span, mix=0.5, mttr=0.08 * span, renewal=True,
        max_events=max_events,
        hazard=HazardConfig(mttf_s=10.0 * span, shape=1.0,
                            lemon_frac=lemon_frac, lemon_factor=60.0))


@register("infant_mortality")
def _infant_mortality(span: float = 160.0,
                      max_events: int = 16) -> FailureScenario:
    # fresh fleet, decreasing hazard (Weibull k<1): an early burn-in burst
    # that quiets down as survivors age past their infancy
    return PoissonFailures(
        rate=0.0, t_end=span, mix=0.5, mttr=0.10 * span, renewal=True,
        max_events=max_events,
        hazard=HazardConfig(mttf_s=8.0 * span, shape=0.6))


# --------------------------------- correlated-domain families (this PR)
@register("pdu_brownout")
def _pdu_brownout(span: float = 160.0, mix: float = 0.7,
                  max_events: int = 64, bad_frac: float = 0.05,
                  factor: float = 64.0) -> FailureScenario:
    # a seeded PDU domain goes bad (``bad_frac`` is a fraction of domains
    # with an at-least-one guarantee, so small fleets get exactly one hot
    # rack): every resident device's memoryless hazard rate is multiplied
    # by ``factor``, so failures concentrate inside the browned-out rack
    # and — with renewal repairs — recur there. Mostly fail-stop (mix=0.7,
    # the power-domain signature) over a *thin* healthy-fleet background
    # (mttf 16 spans — pooled domain detection lives or dies on the
    # contrast between rack rate and background rate, not on raw counts).
    # The pooled DomainEstimator should bench the rack after two distinct
    # resident failures, before its third device dies; repairs land in
    # ~0.1 spans, long enough for the heartbeat to see every death.
    return PoissonFailures(
        rate=0.0, t_end=span, mix=mix, mttr=0.10 * span, renewal=True,
        max_events=max_events, severity=(0.3, 0.55),
        hazard=HazardConfig(mttf_s=16.0 * span, shape=1.0,
                            bad_domain_frac=bad_frac,
                            bad_domain_factor=factor, domain="pdu"))


@register("switch_degrade")
def _switch_degrade(span: float = 160.0, link_scale: float = 0.35,
                    n_switches: int = 1) -> FailureScenario:
    # a flaky leaf-switch uplink: every node under the switch degrades
    # together in a staggered onset, restored after the failover
    return CorrelatedSwitchDegrade(at=0.15 * span, n_switches=n_switches,
                                   link_scale=link_scale,
                                   stagger=0.01 * span,
                                   recover_after=0.45 * span)


@register("restart_storm")
def _restart_storm(span: float = 160.0, frac: float = 0.25,
                   n_storms: int = 2) -> FailureScenario:
    # two job-restart storms: a quarter of the fleet mass-exits and
    # mass-rejoins after a downtime, then it happens again
    return RestartStorm(at=0.15 * span, frac=frac,
                        downtime=0.06 * span, stagger=0.002 * span,
                        n_storms=n_storms, period=0.30 * span)


# ================================================== mined adversarial family
@dataclass
class AdversarialScenario(FailureScenario):
    """A mined worst-case timeline (``tools/mine_scenarios.py``).

    The timeline is literal ``(t, kind, target, value)`` events discovered by
    the coverage-guided search in :mod:`repro_torch.cluster.mining` at the 256-device
    mining scale. On the mining topology with the mined span it replays
    verbatim; on any other topology (or with ``span`` overridden) the events
    are rescaled in time and routed through
    :func:`repro_torch.cluster.mining.repair_timeline`, which remaps victims
    (device/node ids mod the topology size) and drops whatever the remap made
    contradictory — so the same mined pattern replays, valid, at any scale
    (the engine-parity tests run it on an 8-device config)."""

    timeline: Sequence[tuple]
    mined_span: float
    span: Optional[float] = None
    label: str = "adversarial"

    @property
    def name(self) -> str:
        return self.label

    def events(self, topo: ClusterTopology, rng: np.random.Generator
               ) -> Iterable[Event]:
        from repro_torch.cluster.mining import repair_timeline
        span = self.span if self.span is not None else self.mined_span
        scale = span / self.mined_span
        raw = [(t * scale, kind, target, value)
               for t, kind, target, value in self.timeline]
        for t, kind, target, value in repair_timeline(raw, topo, span):
            yield self._ev(t, kind, target, value)


# Mined by the fixed quick recipe (see tools/mine_scenarios.py QUICK);
# regenerate with `PYTHONPATH=src python tools/mine_scenarios.py --quick`
# and keep in lockstep with results/adversarial_mined.json — the nightly
# --check smoke and tests/test_adversarial_golden.py pin both sides.
# The three members cover the search objectives: best combined score,
# deepest raw resihp session-throughput loss, widest policy-ranking flip.
_ADVERSARIAL_SPAN = 7.36203  # the quick recipe's mining span (seconds)
_ADVERSARIAL = {
    # objective: score | lineage g12.0<-g9.0<-g7.7<-seed:infant_mortality
    # resihp session 18.397508441 (loss 0.7650, flip margin 0.4501)
    "adversarial_1": (
        (0.003112, "fail-slow", 161, 0.506201),
        (0.004003, "fail-stop", 39, 0.0),
        (0.004042, "fail-stop", 73, 0.0),
        (0.016146, "fail-slow", 143, 0.493315),
        (0.018257, "fail-stop", 217, 0.0),
        (0.034974, "fail-slow", 82, 0.363836),
        (0.097138, "fail-stop", 20, 0.0),
        (0.101375, "fail-stop", 130, 0.0),
        (0.101584, "fail-stop", 173, 0.0),
        (0.124755, "rejoin", 161, 0.0),
        (0.142091, "rejoin", 39, 0.0),
        (0.145432, "fail-stop", 1, 0.0),
        (0.156805, "fail-slow", 32, 0.371525),
        (0.165517, "fail-stop", 124, 0.0),
        (0.183462, "rejoin", 173, 0.0),
        (0.209743, "fail-stop", 21, 0.0),
        (0.315755, "fail-stop", 109, 0.0),
        (0.37975, "rejoin", 143, 0.0),
        (0.398323, "fail-slow", 121, 0.551146),
        (0.428592, "fail-stop", 185, 0.0),
        (0.480845, "rejoin", 121, 0.0),
        (0.496868, "fail-stop-node", 9, 0.0),
        (0.497922, "rejoin", 124, 0.0),
        (0.572879, "rejoin", 130, 0.841926),
        (0.696512, "rejoin", 217, 0.0),
        (0.892934, "rejoin", 185, 0.0),
        (1.090436, "rejoin", 20, 0.0),
        (1.125776, "rejoin", 1, 0.0),
        (1.144623, "rejoin", 32, 0.0),
        (1.429767, "rejoin", 109, 0.0),
        (1.924609, "rejoin", 82, 0.0),
        (2.119534, "rejoin", 21, 0.0),
        (2.164811, "fail-stop-node", 27, 0.0),
        (5.190934, "fail-slow", 208, 0.24532),
    ),
    # objective: resihp_loss | lineage g7.7<-seed:infant_mortality
    # resihp session 14.570841462 (loss 0.8139, flip margin 0.1438)
    "adversarial_2": (
        (0.002702, "fail-slow", 114, 0.506201),
        (0.003475, "fail-stop", 248, 0.0),
        (0.003509, "fail-stop", 26, 0.0),
        (0.014018, "fail-slow", 96, 0.493315),
        (0.015851, "fail-stop", 170, 0.0),
        (0.030365, "fail-slow", 35, 0.363836),
        (0.084336, "fail-stop", 229, 0.0),
        (0.088014, "fail-stop", 83, 0.0),
        (0.088196, "fail-stop", 126, 0.0),
        (0.108313, "rejoin", 114, 0.0),
        (0.123364, "rejoin", 248, 0.0),
        (0.126265, "fail-stop", 210, 0.0),
        (0.136139, "fail-slow", 241, 0.371525),
        (0.143703, "fail-stop", 77, 0.0),
        (0.159283, "rejoin", 126, 0.0),
        (0.1821, "fail-stop", 230, 0.0),
        (0.27414, "fail-stop", 62, 0.0),
        (0.329701, "rejoin", 96, 0.0),
        (0.345826, "fail-slow", 74, 0.551146),
        (0.372106, "fail-stop", 138, 0.0),
        (0.417472, "rejoin", 74, 0.0),
        (0.432299, "rejoin", 77, 0.0),
        (0.497377, "rejoin", 83, 0.841926),
        (0.604716, "rejoin", 170, 0.0),
        (0.77525, "rejoin", 138, 0.0),
        (0.946723, "rejoin", 229, 0.0),
        (0.977405, "rejoin", 210, 0.0),
        (0.993768, "rejoin", 241, 0.0),
        (1.241332, "rejoin", 62, 0.0),
        (1.670956, "rejoin", 35, 0.0),
        (1.840191, "rejoin", 230, 0.0),
        (1.879501, "fail-stop-node", 12, 0.0),
        (4.506798, "fail-slow", 161, 0.24532),
        (5.394335, "rejoin", 26, 0.0),
    ),
    # objective: flip_margin | lineage g9.0<-g7.7<-seed:infant_mortality
    # resihp session 24.206351095 (loss 0.6908, flip margin 0.3995)
    "adversarial_3": (
        (0.002702, "fail-slow", 114, 0.506201),
        (0.003475, "fail-stop", 248, 0.0),
        (0.003509, "fail-stop", 26, 0.0),
        (0.014018, "fail-slow", 96, 0.493315),
        (0.015851, "fail-stop", 170, 0.0),
        (0.030365, "fail-slow", 35, 0.363836),
        (0.084336, "fail-stop", 229, 0.0),
        (0.088014, "fail-stop", 83, 0.0),
        (0.088196, "fail-stop", 126, 0.0),
        (0.108313, "rejoin", 114, 0.0),
        (0.123364, "rejoin", 248, 0.0),
        (0.126265, "fail-stop", 210, 0.0),
        (0.136139, "fail-slow", 241, 0.371525),
        (0.143703, "fail-stop", 77, 0.0),
        (0.159283, "rejoin", 126, 0.0),
        (0.1821, "fail-stop", 230, 0.0),
        (0.27414, "fail-stop", 62, 0.0),
        (0.329701, "rejoin", 96, 0.0),
        (0.345826, "fail-slow", 74, 0.551146),
        (0.372106, "fail-stop", 138, 0.0),
        (0.417472, "rejoin", 74, 0.0),
        (0.432299, "rejoin", 77, 0.0),
        (0.497377, "rejoin", 83, 0.841926),
        (0.604716, "rejoin", 170, 0.0),
        (0.77525, "rejoin", 138, 0.0),
        (0.946723, "rejoin", 229, 0.0),
        (0.977405, "rejoin", 210, 0.0),
        (0.993768, "rejoin", 241, 0.0),
        (1.241332, "rejoin", 62, 0.0),
        (1.670956, "rejoin", 35, 0.0),
        (1.840191, "rejoin", 230, 0.0),
        (1.879501, "fail-stop-node", 12, 0.0),
        (4.506798, "fail-slow", 161, 0.24532),
    ),
}


def _register_adversarial(name: str) -> None:
    @register(name)
    def _factory(span: Optional[float] = None) -> FailureScenario:
        return AdversarialScenario(timeline=_ADVERSARIAL[name],
                                   mined_span=_ADVERSARIAL_SPAN,
                                   span=span, label=name)


for _name in sorted(_ADVERSARIAL):
    _register_adversarial(_name)
del _name
