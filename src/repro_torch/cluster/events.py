"""Failure-event timeline: the compiled form of a FailureScenario.

A scenario compiles to a flat, time-sorted list of :class:`Event` records.
Events are plain data (kind + target + value) so a timeline can be exported,
diffed, replayed and asserted on byte-for-byte; the one exception is the
``callback`` kind which carries an opaque function and exists only to back
the legacy ``TrainingSim.inject_at`` shim.

Event kinds
-----------
``fail-stop``       device ``target`` terminates (speed 0, heartbeats stop)
``fail-stop-node``  every device on node ``target`` terminates
``fail-slow``       device ``target`` degrades to ``value`` x peak speed
``net-degrade``     node ``target`` link contention, bandwidth scale ``value``
``net-restore``     node ``target`` link contention cleared (network
                    component only — dead/slow devices stay dead/slow)
``rejoin``          device ``target`` repaired AND re-announced to the system
                    (the elastic-rejoin model: the scheduler learns the device
                    is back, unlike a silent repair). ``value`` in (0, 1)
                    means the device returns *degraded* to that fraction of
                    peak speed; 0.0 (the default) means full health
``callback``        opaque ``fn(cluster, now)`` — inject_at compatibility

A copy of `repro.cluster.events`, kept whole here, without importing the
JAX package.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

KINDS = (
    "fail-stop",
    "fail-stop-node",
    "fail-slow",
    "net-degrade",
    "net-restore",
    "rejoin",
    "callback",
)

DEVICE_KINDS = ("fail-stop", "fail-slow", "rejoin")
NODE_KINDS = ("fail-stop-node", "net-degrade", "net-restore")


class TraceValidationError(ValueError):
    """An event timeline is contradictory or out of range for its topology
    (see :meth:`EventTrace.validate`). Raised instead of letting the
    simulator silently mis-simulate an impossible sequence."""


@dataclass(frozen=True, order=True)
class Event:
    t: float
    kind: str
    target: int = -1
    value: float = 0.0
    scenario: str = ""  # provenance: which scenario emitted this event
    fn: Optional[Callable] = field(default=None, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; one of {KINDS}")

    def as_tuple(self) -> tuple:
        return (float(self.t), self.kind, int(self.target),
                float(self.value), self.scenario)


def encode_rejoin_speed(speed: float) -> float:
    """``Event.value`` encoding for a rejoin's return speed: 0.0 (the Event
    default, emitted by every pre-existing scenario) means full health; a
    value in (0, 1) is a degraded return. A rejoin always brings the device
    back alive — "returns dead" is not a rejoin."""
    return speed if 0.0 < speed < 1.0 else 0.0


def decode_rejoin_speed(value: float) -> float:
    return value if 0.0 < value < 1.0 else 1.0


def apply_event(ev: Event, cluster, now: float, *, on_rejoin=None) -> None:
    """Apply one event to a ClusterState; ``on_rejoin(device)`` lets the
    caller propagate elastic rejoins into system beliefs."""
    if ev.kind == "fail-stop":
        cluster.fail_stop(ev.target, now)
    elif ev.kind == "fail-stop-node":
        cluster.fail_stop_node(ev.target, now)
    elif ev.kind == "fail-slow":
        cluster.fail_slow(ev.target, ev.value, now)
    elif ev.kind == "net-degrade":
        cluster.degrade_network(ev.target, ev.value, now=now)
    elif ev.kind == "net-restore":
        cluster.restore_network(ev.target, now=now)
    elif ev.kind == "rejoin":
        cluster.repair(ev.target, now, speed=decode_rejoin_speed(ev.value))
        if on_rejoin is not None:
            on_rejoin(ev.target)
    elif ev.kind == "callback":
        ev.fn(cluster, now)


class EventTrace:
    """A time-sorted event timeline with export/merge/replay helpers."""

    def __init__(self, events: Iterable[Event] = ()):
        self.events: list[Event] = sorted(events)

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def __getitem__(self, i):
        return self.events[i]

    def __eq__(self, other):
        if not isinstance(other, EventTrace):
            return NotImplemented
        return self.events == other.events

    def merge(self, other: "EventTrace") -> "EventTrace":
        return EventTrace([*self.events, *other.events])

    def validate(self, topo) -> "EventTrace":
        """Reject timelines the simulator would silently mis-simulate.

        Checks, per event in time order (``callback`` events are opaque and
        skipped):

        * finite, non-negative times and finite values;
        * device targets in ``[0, n_devices)`` for device-kind events and
          node targets in ``[0, n_nodes)`` for node-kind events;
        * value ranges: fail-slow severity in ``(0, 1]``, rejoin return
          speed encoding in ``[0, 1)`` (see :func:`encode_rejoin_speed`),
          net-degrade link scale in ``(0, 1]``;
        * a consistent per-device lifecycle: no fail-stop/fail-slow of an
          already-dead device (a double kill means two generators disagree
          about who owns the victim), no ``rejoin`` of a device that never
          failed, no ``fail-stop-node`` of a node whose devices are all
          already dead, no ``net-restore`` without an active degrade.

        Returns ``self`` so calls chain; raises
        :class:`TraceValidationError` naming the offending event otherwise.
        Every catalog scenario compiles clean under this check
        (``tests/test_scenarios.py`` pins it); the adversarial miner's
        mutation operators route every candidate through
        :func:`repro_torch.cluster.mining.repair_timeline`, which canonicalizes
        arbitrary event soups into timelines that pass."""
        n_dev, n_nodes = topo.n_devices, topo.n_nodes

        def err(i, ev, msg):
            raise TraceValidationError(
                f"event {i} (t={ev.t}, kind={ev.kind!r}, target={ev.target}, "
                f"value={ev.value}): {msg}")

        alive: dict = {}       # device -> liveness (default True)
        degraded: set = set()  # devices currently running below peak
        net_down: set = set()  # nodes with an active link degrade
        for i, ev in enumerate(self.events):
            if ev.kind == "callback":
                continue
            if not math.isfinite(ev.t) or ev.t < 0.0:
                err(i, ev, "event time must be finite and >= 0")
            if not math.isfinite(ev.value):
                err(i, ev, "event value must be finite")
            if ev.kind in DEVICE_KINDS and not 0 <= ev.target < n_dev:
                err(i, ev, f"device id out of range for a {n_dev}-device "
                           "topology")
            if ev.kind in NODE_KINDS and not 0 <= ev.target < n_nodes:
                err(i, ev, f"node id out of range for a {n_nodes}-node "
                           "topology")
            if ev.kind == "fail-stop":
                if not alive.get(ev.target, True):
                    err(i, ev, "device is already dead (double fail-stop "
                               "without an intervening rejoin)")
                alive[ev.target] = False
            elif ev.kind == "fail-stop-node":
                devs = range(ev.target * topo.devices_per_node,
                             (ev.target + 1) * topo.devices_per_node)
                if all(not alive.get(d, True) for d in devs):
                    err(i, ev, "every device on the node is already dead")
                for d in devs:
                    alive[d] = False
            elif ev.kind == "fail-slow":
                if not 0.0 < ev.value <= 1.0:
                    err(i, ev, "fail-slow severity must be in (0, 1] "
                               "(remaining fraction of peak speed)")
                if not alive.get(ev.target, True):
                    err(i, ev, "fail-slow on a dead device (it has no speed "
                               "to degrade; rejoin it first)")
                degraded.add(ev.target)
            elif ev.kind == "rejoin":
                if not 0.0 <= ev.value < 1.0:
                    err(i, ev, "rejoin value must be the encode_rejoin_speed "
                               "encoding: 0.0 = full health, (0, 1) = "
                               "degraded return")
                if alive.get(ev.target, True) and ev.target not in degraded:
                    err(i, ev, "rejoin before any failure of the device "
                               "(nothing to repair or recover from)")
                alive[ev.target] = True
                degraded.discard(ev.target)
                if 0.0 < ev.value < 1.0:
                    degraded.add(ev.target)  # returned below peak
            elif ev.kind == "net-degrade":
                if not 0.0 < ev.value <= 1.0:
                    err(i, ev, "net-degrade link scale must be in (0, 1] "
                               "(remaining fraction of bandwidth)")
                net_down.add(ev.target)
            elif ev.kind == "net-restore":
                if ev.target not in net_down:
                    err(i, ev, "net-restore without an active net-degrade "
                               "on the node")
                net_down.discard(ev.target)  # restore clears all contention
        return self

    def as_tuples(self) -> list:
        return [ev.as_tuple() for ev in self.events]

    def to_json(self) -> str:
        """Canonical serialization — byte-identical for identical timelines
        (callback events are not serializable by design)."""
        if any(ev.kind == "callback" for ev in self.events):
            raise ValueError("callback events cannot be serialized")
        return json.dumps(self.as_tuples(), separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "EventTrace":
        return cls(Event(t, kind, target, value, scenario)
                   for t, kind, target, value, scenario in json.loads(text))
