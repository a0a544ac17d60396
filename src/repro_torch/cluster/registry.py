"""Cluster device registry + failure injection.

Devices carry a normalized throughput p (1.0 = healthy peak) and a liveness
bit; nodes group devices (heartbeat locality + NVLink/ICI domain). Injection
mirrors the paper's §8.1 methodology:

  * fail-stop        — worker terminated (speed 0, heartbeats stop);
  * compute fail-slow — SM-clock-lock analogue: multiply device speed;
  * network fail-slow — bandwidth contention on a node's links: multiplies
    the communication-sensitive share of affected devices' throughput.

Array-native core
-----------------
Ground truth lives in preallocated dense numpy arrays over device ids
``0..n-1`` — ``speed``, ``net_scale``, ``alive``, ``age`` (sim-time the
device last (re)entered service) and ``node_of`` — so the simulator hot path
(validation scans, heartbeat masks, stage-speed reductions) is C-speed at
16k+ devices. The original dict/object API (``cluster.devices[i].alive``
etc.) is kept as a thin **adapter view**: :class:`DeviceView` proxies read
and write the arrays in place, and ``cluster.devices`` behaves like the old
insertion-ordered dict. Contract:

  * every mutation (injection method or adapter-attribute write) bumps
    ``cluster.version`` — consumers key caches on it;
  * ``effective()`` / ``alive_mask()`` return cached **read-only** array
    views, rebuilt lazily after a version bump;
  * ``speeds()`` (the legacy dict form) is likewise rebuilt only after a
    mutation — identical floats, since the array product ``speed *
    net_scale`` is the same IEEE-754 multiply the old per-object property
    performed.

A copy of `repro.cluster.registry`, kept whole here, without importing the
JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Device:
    """Plain standalone device record (kept for back-compat construction);
    inside :class:`ClusterState` devices are rows of the arrays, surfaced
    through :class:`DeviceView`."""

    id: int
    node: int
    speed: float = 1.0  # normalized compute throughput p_i
    net_scale: float = 1.0  # link-contention multiplier (1.0 = clean links)
    alive: bool = True

    @property
    def effective(self) -> float:
        return self.speed * self.net_scale if self.alive else 0.0


@dataclass(frozen=True)
class ClusterTopology:
    """Physical layout: nodes of ``devices_per_node`` devices, grouped into
    correlated failure domains. A *rack* is a node (the heartbeat/NVLink
    domain the repo always had); ``nodes_per_pdu`` racks share one power
    distribution unit and ``nodes_per_switch`` racks share one leaf switch —
    the two correlation domains fleet reliability reports blame for most
    multi-device incidents (a browned-out PDU elevates every resident
    device's failure rate; a flaky switch degrades every resident link).
    The defaults (PDU == rack, two racks per switch) keep every existing
    two-argument construction byte-compatible."""

    n_nodes: int
    devices_per_node: int = 8
    nodes_per_pdu: int = 1
    nodes_per_switch: int = 2

    def __post_init__(self):
        if self.nodes_per_pdu < 1 or self.nodes_per_switch < 1:
            raise ValueError("nodes_per_pdu / nodes_per_switch must be >= 1")

    @property
    def n_devices(self) -> int:
        return self.n_nodes * self.devices_per_node

    def node_of(self, device_id: int) -> int:
        return device_id // self.devices_per_node

    # ------------------------------------------------------ failure domains
    @property
    def n_pdus(self) -> int:
        return -(-self.n_nodes // self.nodes_per_pdu)

    @property
    def n_switches(self) -> int:
        return -(-self.n_nodes // self.nodes_per_switch)

    def pdu_of(self, device_id: int) -> int:
        return self.node_of(device_id) // self.nodes_per_pdu

    def switch_of(self, device_id: int) -> int:
        return self.node_of(device_id) // self.nodes_per_switch

    def domain_of(self, device_id: int, kind: str = "pdu") -> int:
        """Domain index of a device under ``kind`` ('pdu' | 'switch' |
        'node'/'rack')."""
        if kind == "pdu":
            return self.pdu_of(device_id)
        if kind == "switch":
            return self.switch_of(device_id)
        if kind in ("node", "rack"):
            return self.node_of(device_id)
        raise ValueError(f"unknown domain kind {kind!r}")

    def domain_nodes(self, kind: str, index: int) -> list:
        """Node ids resident in one domain (for ``kind='node'`` the domain
        *is* the node)."""
        per = {"pdu": self.nodes_per_pdu, "switch": self.nodes_per_switch,
               "node": 1, "rack": 1}.get(kind)
        if per is None:
            raise ValueError(f"unknown domain kind {kind!r}")
        lo = index * per
        return [n for n in range(lo, min(lo + per, self.n_nodes))]

    def domain_devices(self, kind: str, index: int) -> list:
        """Device ids resident in one domain, ascending."""
        return [d for n in self.domain_nodes(kind, index)
                for d in range(n * self.devices_per_node,
                               (n + 1) * self.devices_per_node)]


class DeviceView:
    """Write-through adapter over one row of the ClusterState arrays —
    attribute-compatible with the old ``Device`` dataclass."""

    __slots__ = ("_cs", "id")

    def __init__(self, cs: "ClusterState", device_id: int):
        self._cs = cs
        self.id = device_id

    @property
    def node(self) -> int:
        return int(self._cs.node_of[self.id])

    @property
    def speed(self) -> float:
        return float(self._cs._speed[self.id])

    @speed.setter
    def speed(self, v: float):
        self._cs._speed[self.id] = float(v)
        self._cs._touch()

    @property
    def net_scale(self) -> float:
        return float(self._cs._net[self.id])

    @net_scale.setter
    def net_scale(self, v: float):
        self._cs._net[self.id] = float(v)
        self._cs._touch()

    @property
    def alive(self) -> bool:
        return bool(self._cs._alive[self.id])

    @alive.setter
    def alive(self, v: bool):
        self._cs._alive[self.id] = bool(v)
        self._cs._touch()

    @property
    def effective(self) -> float:
        cs = self._cs
        if not cs._alive[self.id]:
            return 0.0
        return float(cs._speed[self.id]) * float(cs._net[self.id])

    def __repr__(self):
        return (f"DeviceView(id={self.id}, node={self.node}, "
                f"speed={self.speed}, net_scale={self.net_scale}, "
                f"alive={self.alive})")


class _DeviceMap:
    """Read-only mapping facade over the arrays: iteration order and key set
    match the old ``{0: Device, 1: Device, ...}`` dict exactly."""

    __slots__ = ("_cs",)

    def __init__(self, cs: "ClusterState"):
        self._cs = cs

    def __getitem__(self, device_id: int) -> DeviceView:
        if not 0 <= device_id < self._cs.n_devices:
            raise KeyError(device_id)
        return DeviceView(self._cs, device_id)

    def __len__(self) -> int:
        return self._cs.n_devices

    def __iter__(self):
        return iter(range(self._cs.n_devices))

    def __contains__(self, device_id) -> bool:
        return isinstance(device_id, (int, np.integer)) \
            and 0 <= device_id < self._cs.n_devices

    def keys(self):
        return range(self._cs.n_devices)

    def values(self):
        cs = self._cs
        return (DeviceView(cs, i) for i in range(cs.n_devices))

    def items(self):
        cs = self._cs
        return ((i, DeviceView(cs, i)) for i in range(cs.n_devices))


class ClusterState:
    """Array-native cluster ground truth (see module docstring)."""

    def __init__(self, topo: ClusterTopology, events=None):
        self.topo = topo
        n = topo.n_devices
        self._speed = np.ones(n, dtype=np.float64)
        self._net = np.ones(n, dtype=np.float64)
        self._alive = np.ones(n, dtype=np.bool_)
        # sim-time each device last (re)entered service (0.0 at birth,
        # stamped by ``repair``) — the per-device age anchor hazard-aware
        # tooling reads as ``now - age``
        self._age = np.zeros(n, dtype=np.float64)
        self.node_of = np.arange(n, dtype=np.intp) // topo.devices_per_node
        self.events = list(events) if events else []  # injection log
        self.devices = _DeviceMap(self)
        self.version = 0  # bumped on every mutation (cache-invalidation key)
        self._eff = None  # cached effective-speed array
        self._speeds_dict = None  # cached legacy dict form
        self._node_members = None  # node -> [device ids], built lazily

    # ------------------------------------------------------------ mutation
    def _touch(self):
        self.version += 1
        self._eff = None
        self._speeds_dict = None

    # ------------------------------------------------------------ queries
    def effective(self) -> np.ndarray:
        """Dense effective-speed vector (``speed * net_scale``, 0.0 when
        dead) over device ids ``0..n-1`` — a cached read-only view, rebuilt
        only after a mutation."""
        if self._eff is None:
            eff = self._speed * self._net
            eff[~self._alive] = 0.0
            eff.flags.writeable = False
            self._eff = eff
        return self._eff

    def speeds(self) -> dict:
        """Legacy dict form ``{device_id: effective}`` — cached slice of the
        effective array, invalidated on mutation."""
        if self._speeds_dict is None:
            self._speeds_dict = dict(enumerate(self.effective().tolist()))
        return self._speeds_dict

    def alive_ids(self) -> list:
        return np.nonzero(self._alive)[0].tolist()

    def alive_mask(self) -> np.ndarray:
        """Dense liveness vector over the device ids ``0..n-1`` for the
        vectorized heartbeat path — one bool per device (read-only view of
        the ground-truth array)."""
        v = self._alive.view()
        v.flags.writeable = False
        return v

    def ages(self, now: float) -> np.ndarray:
        """Per-device service age in seconds at time ``now`` (time since
        birth or last repair)."""
        return np.maximum(now - self._age, 0.0)

    @property
    def n_devices(self) -> int:
        return self.topo.n_devices

    def node_devices(self, node: int) -> list:
        if self._node_members is None:
            members = [[] for _ in range(self.topo.n_nodes)]
            for d, nd in enumerate(self.node_of.tolist()):
                members[nd].append(d)
            self._node_members = members
        return list(self._node_members[node])

    def _node_rows(self, node: int) -> np.ndarray:
        return np.nonzero(self.node_of == node)[0]

    # ---------------------------------------------------------- injection
    def fail_stop(self, device_id: int, now: float = 0.0):
        self._alive[device_id] = False
        self._touch()
        self.events.append((now, "fail-stop", device_id, 0.0))

    def fail_stop_node(self, node: int, now: float = 0.0):
        self._alive[self._node_rows(node)] = False
        self._touch()
        self.events.append((now, "fail-stop-node", node, 0.0))

    def fail_slow(self, device_id: int, factor: float, now: float = 0.0):
        """factor = remaining fraction of peak (0.5 = half speed)."""
        self._speed[device_id] = float(factor)
        self._touch()
        self.events.append((now, "fail-slow", device_id, factor))

    def degrade_network(self, node: int, factor: float, comm_share: float = 0.3,
                        now: float = 0.0):
        """Bandwidth contention on a node: the communication share of each
        device's step time stretches by 1/factor. Tracked separately from
        compute speed so clearing the contention restores exactly this
        component (a co-located compute straggler stays slow)."""
        eff = 1.0 / ((1.0 - comm_share) + comm_share / max(factor, 1e-9))
        rows = self._node_rows(node)
        self._net[rows] = np.minimum(self._net[rows], eff)
        self._touch()
        self.events.append((now, "net-degrade", node, factor))

    def restore_network(self, node: int, now: float = 0.0):
        """Link contention cleared: only the network component recovers —
        dead devices stay dead, compute fail-slows stay slow."""
        self._net[self._node_rows(node)] = 1.0
        self._touch()
        self.events.append((now, "net-restore", node, 1.0))

    def repair(self, device_id: int, now: float = 0.0, speed: float = 1.0):
        """Bring a device back; ``speed < 1.0`` models a degraded return
        (swapped-in older part, partially-recovered thermal state) — the
        case rejoin admission probing exists for."""
        self._alive[device_id] = True
        self._speed[device_id] = float(speed)
        self._net[device_id] = 1.0
        self._age[device_id] = float(now)
        self._touch()
        self.events.append((now, "repair", device_id, float(speed)))
