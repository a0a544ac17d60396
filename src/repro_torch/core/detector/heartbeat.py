"""Hierarchical two-level heartbeat fail-stop detection (paper §5.1, §7).

Intra-node: every worker (device) periodically reports a compact liveness
signal + local training progress to its node-local monitor; the monitor marks
a device failed after `miss_threshold` consecutive missed heartbeats.
Inter-node: a central coordinator tracks only node monitors (a TCP socket per
node in the paper; a registered endpoint here) — so coordinator load scales
with nodes, not devices. A dead node monitor fails the whole node.

The wire is simulated (in-process, clock-driven) but the protocol and state
machines are the real ones; `ClusterSim` advances `now` and calls `beat` for
every live device each interval.

A copy of `repro.core.detector.heartbeat`, kept here so that the port runs
the Detector on times measured on the card without importing the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class DeviceHB:
    last_beat: float = -1.0
    last_progress: int = -1
    missed: int = 0
    failed: bool = False


@dataclass
class NodeMonitor:
    """Node-local aggregator: raw device heartbeats stay on the node."""

    node_id: int
    devices: list  # device ids hosted on this node
    interval: float = 1.0
    miss_threshold: int = 3
    state: dict = field(default_factory=dict)
    alive: bool = True

    def __post_init__(self):
        for d in self.devices:
            self.state[d] = DeviceHB()

    def beat(self, device_id, now: float, progress: int = 0):
        hb = self.state[device_id]
        hb.last_beat = now
        hb.last_progress = progress
        hb.missed = 0

    def sweep(self, now: float) -> list:
        """Periodic check; returns newly-failed device ids (the only thing
        forwarded upstream — decisions, not raw beats)."""
        newly = []
        for d, hb in self.state.items():
            if hb.failed:
                continue
            expected = int((now - hb.last_beat) / self.interval) if hb.last_beat >= 0 else 10**9
            hb.missed = max(hb.missed, expected)
            if hb.missed >= self.miss_threshold:
                hb.failed = True
                newly.append(d)
        return newly


@dataclass
class HeartbeatMonitor:
    """Central coordinator over node monitors (level 2)."""

    interval: float = 1.0
    miss_threshold: int = 3
    nodes: dict = field(default_factory=dict)  # node_id -> NodeMonitor
    node_last_seen: dict = field(default_factory=dict)
    failed_devices: set = field(default_factory=set)
    failed_nodes: set = field(default_factory=set)
    device_node: dict = field(default_factory=dict)  # device_id -> node_id
    on_failstop: Optional[Callable] = None  # callback(list[device_id], now)

    def register_node(self, node_id: int, device_ids: list) -> NodeMonitor:
        mon = NodeMonitor(node_id, list(device_ids), self.interval, self.miss_threshold)
        self.nodes[node_id] = mon
        self.node_last_seen[node_id] = -1.0
        for d in device_ids:
            self.device_node[d] = node_id
        return mon

    # -------------------------------------------------------------- ingest
    def device_beat(self, node_id: int, device_id, now: float, progress: int = 0):
        if node_id in self.failed_nodes or not self.nodes[node_id].alive:
            return  # dead node's agent can't relay
        self.nodes[node_id].beat(device_id, now, progress)

    def node_beat(self, node_id: int, now: float):
        """The node agent's own keepalive on the TCP side channel."""
        self.node_last_seen[node_id] = now

    def kill_node(self, node_id: int):
        """Simulate a node crash: its agent stops beating entirely."""
        self.nodes[node_id].alive = False

    def mark_failed(self, device_id):
        """Record a device as failed through an out-of-band channel (a
        validation pass that found it dead — the validation-as-fail-stop
        path). The next sweep will not re-report it, so the NCCL-timeout
        stall is not paid twice for a failure the system already knows."""
        nid = self.device_node.get(device_id)
        if nid is not None:
            hb = self.nodes[nid].state[device_id]
            hb.failed = True
        self.failed_devices.add(device_id)

    # -------------------------------------------------------------- revive
    def revive(self, device_id, now: float = 0.0):
        """A repaired device re-announces itself (elastic rejoin): clear the
        failed state so its *next* fail-stop is detectable again. Without
        this, ``failed_devices`` / ``DeviceHB.failed`` were never cleared and
        a flapping or renewal-process device could silently die a second
        time. The device is credited a fresh beat at ``now`` so it is not
        instantly re-failed before its first post-rejoin heartbeat."""
        nid = self.device_node.get(device_id)
        if nid is None:
            return
        if nid in self.failed_nodes or not self.nodes[nid].alive:
            self.revive_node(nid, now)
        hb = self.nodes[nid].state[device_id]
        hb.failed = False
        hb.missed = 0
        hb.last_beat = now
        self.failed_devices.discard(device_id)

    def revive_node(self, node_id: int, now: float = 0.0):
        """Restore a node agent's side channel (node repaired / rack power
        back). Devices on the node stay individually failed until they are
        revived themselves."""
        self.failed_nodes.discard(node_id)
        mon = self.nodes[node_id]
        mon.alive = True
        self.node_last_seen[node_id] = now

    # --------------------------------------------------------------- sweep
    def sweep(self, now: float) -> list:
        """Run both levels; returns newly failed device ids."""
        newly = []
        for nid, mon in self.nodes.items():
            if nid in self.failed_nodes:
                continue
            last = self.node_last_seen[nid]
            expected = int((now - last) / self.interval) if last >= 0 else 10**9
            if not mon.alive or expected >= self.miss_threshold:
                # socket disconnection: fail the whole node immediately
                self.failed_nodes.add(nid)
                for d in mon.devices:
                    if d not in self.failed_devices:
                        self.failed_devices.add(d)
                        newly.append(d)
                continue
            for d in mon.sweep(now):
                if d not in self.failed_devices:
                    self.failed_devices.add(d)
                    newly.append(d)
        if newly and self.on_failstop is not None:
            self.on_failstop(newly, now)
        return newly

    # ------------------------------------------------------------ stats
    @property
    def n_messages_per_interval(self) -> int:
        """Coordinator-side message load: one per *node*, not per device —
        the scalability claim of §5.1."""
        return len(self.nodes)
