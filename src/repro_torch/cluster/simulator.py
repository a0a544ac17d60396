"""Discrete-event cluster training simulator (the §8 evaluation harness).

Executes a training job iteration by iteration at cluster scale with the
*actual* system code in the loop:

  * ground-truth chunk times come from the Eq. 1 functional form with the
    per-iteration packed workload (real packing of lognormal documents) and
    the injected true device speeds;
  * pipeline execution (with cross-DP migration) is simulated by
    ProgressAwareMigrator — the same engine the Scheduler ships;
  * the real Detector consumes the observed iteration-time series and the
    real heartbeat hierarchy; its reports drive the real policy/Scheduler;
  * reconfiguration costs (planning, group rebuild, layer transfer) are
    charged per Fig. 13.

The per-iteration trace (time, throughput, events) reproduces Table 6,
Fig. 9, Fig. 10, Fig. 11 and the Fig. 14 large-scale run.

A copy of `repro.cluster.simulator`, kept whole here with both engines.
Importing it and running a simulation loads neither torch nor the JAX
package.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.cluster.baselines import BasePolicy, PolicyDecision, make_policy
from repro_torch.cluster.events import Event, apply_event
from repro_torch.cluster.fastsim import (FastHeartbeat, FastMigrator,
                                   StageSpeedCache, make_cost_table)
from repro_torch.cluster.hazard import DomainEstimator, HazardEstimator
from repro_torch.cluster.registry import ClusterState, ClusterTopology
from repro_torch.cluster.workload import WorkloadGen
from repro_torch.core.detector.changepoint import CusumDetector, SlopeDriftDetector
from repro_torch.core.detector.credit import CreditModel
from repro_torch.core.detector.detector import Detector
from repro_torch.core.detector.heartbeat import HeartbeatMonitor
from repro_torch.core.detector.lifecycle import LifecycleManager
from repro_torch.core.detector.predictor import MicroBatchTimePredictor
from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler.migration import ProgressAwareMigrator
from repro_torch.core.scheduler.plan import NTP_EFFICIENCY, initial_plan


@dataclass
class SimConfig:
    dp: int = 2
    pp: int = 4
    tp: int = 4
    n_layers: int = 40
    n_microbatches: int = 8  # per replica
    seq_len: int = 8192
    rows_per_microbatch: int = 1
    schedule: str = "1f1b"
    # ground-truth per-layer chunk-time coefficients (seconds)
    alpha: float = 2.0e-7  # per token per layer
    beta: float = 1.2e-11  # per (token^2) per layer
    gamma: float = 1.0e-4  # fixed per-chunk per-layer overhead
    b_ratio: float = 2.0
    w_ratio: float = 1.0
    noise: float = 0.01  # multiplicative jitter on true chunk times
    p2p_cost: float = 2.0e-4
    migrate_edge_cost: float = 2.0e-3
    devices_per_node: int = 8
    # correlated failure domains (ClusterTopology defaults: PDU == rack,
    # two racks per leaf switch)
    nodes_per_pdu: int = 1
    nodes_per_switch: int = 2
    # detection model
    failstop_stall_s: float = 4.0  # heartbeat loss -> NCCL-timeout analogue
    failslow_detect_iters: int = 2  # paper Fig. 14: detected in 2-3 iterations
    detector_tax: float = 0.013  # per-iteration Detector overhead (Fig. 13)
    seed: int = 0

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp

    @property
    def samples_per_iter(self) -> int:
        return self.dp * self.n_microbatches * self.rows_per_microbatch


class BeliefArray(dict):
    """The system's believed per-device speeds: the legacy dict API (the
    policies consume ``{device: speed}``) backed by a dense numpy mirror
    (``.arr``) kept in sync on every write — so the validation pass compares
    belief against ground truth in one masked array comparison instead of an
    O(n) dict walk."""

    def __init__(self, n_devices: int):
        super().__init__((i, 1.0) for i in range(n_devices))
        self.arr = np.ones(n_devices, dtype=np.float64)

    def __setitem__(self, device: int, speed: float):
        dict.__setitem__(self, device, speed)
        self.arr[device] = speed


@dataclass
class IterRecord:
    iteration: int
    t_start: float
    duration: float
    throughput: float  # samples/s
    events: list = field(default_factory=list)


class TrainingSim:
    """Cluster training simulator.

    ``engine`` selects the pipeline-execution core:

    * ``"fast"`` (default) — :class:`repro_torch.cluster.fastsim.FastMigrator` with
      vectorized chunk-cost tables: same results bit-for-bit, orders of
      magnitude faster at scale (see ``BENCH_simcore.json``), opening
      1k+-device sweeps;
    * ``"python"`` — the reference
      :class:`~repro_torch.core.scheduler.migration.ProgressAwareMigrator` event
      loop, kept as the semantic anchor and parity baseline.
    """

    def __init__(self, policy_name: str, cfg: SimConfig, *, layer_costs=None,
                 policy_kwargs=None, detector_kwargs=None, engine: str = "fast"):
        if engine not in ("python", "fast"):
            raise ValueError(f"unknown engine {engine!r}; one of ('python', 'fast')")
        self.engine = engine
        self._migrator_cls = FastMigrator if engine == "fast" else ProgressAwareMigrator
        self.cfg = cfg
        self.layer_costs = list(layer_costs) if layer_costs else [1.0] * cfg.n_layers
        self.topo = ClusterTopology(
            math.ceil(cfg.n_devices / cfg.devices_per_node),
            cfg.devices_per_node, nodes_per_pdu=cfg.nodes_per_pdu,
            nodes_per_switch=cfg.nodes_per_switch)
        self.cluster = ClusterState(self.topo)
        self.plan0 = initial_plan(
            cfg.n_layers, cfg.dp, cfg.pp, cfg.tp,
            microbatches=cfg.n_microbatches, schedule=cfg.schedule)
        pk = dict(policy_kwargs or {})
        if policy_name.lower() == "resihp":
            # the §6.1 node-local-standby contract needs the physical
            # topology; explicit policy_kwargs (incl. node_of=None) win
            pk.setdefault("node_of", self.topo.node_of)
            if pk.get("domains"):
                # domain-aware switch: give the Scheduler the device ->
                # failure-domain map for domain-spread standby offers
                kind = getattr(pk["domains"], "domain", "pdu")
                pk.setdefault(
                    "domain_of",
                    lambda d, _k=kind: self.topo.domain_of(d, _k))
        self.policy: BasePolicy = make_policy(
            policy_name, self.plan0, self.layer_costs, **pk)
        self.gen = WorkloadGen(cfg.seq_len, cfg.dp, cfg.n_microbatches,
                               rows_per_microbatch=cfg.rows_per_microbatch,
                               seed=cfg.seed)
        self.rng = np.random.default_rng(cfg.seed + 1)

        # ---- detection stack (real code) ----
        # the fast engine swaps the reference per-device heartbeat monitor
        # for the vectorized FastHeartbeat (same semantics, parity-pinned);
        # the python engine keeps the reference as the semantic anchor
        hb_cls = FastHeartbeat if engine == "fast" else HeartbeatMonitor
        hb = hb_cls(interval=1.0, miss_threshold=3)
        for n in range(self.topo.n_nodes):
            hb.register_node(n, self.cluster.node_devices(n))
        self._fitted = self._fit_predictor()

        # ---- failure lifecycle (flap quarantine / drift / admission) ----
        # built from the policy's default-off ``lifecycle`` switch; the probe
        # is the ElasWave-style rejoin micro-benchmark (ground-truth lookup,
        # cost charged to simulated time like Greyhound's validation pass)
        lc_cfg = getattr(self.policy, "lifecycle", None)
        # per-device hazard awareness (default-off ``hazard`` switch): the
        # estimator reads the lifecycle's FailureHistory — hazard-keyed
        # quarantine inside the manager, risk scores for the Scheduler
        hz_cfg = getattr(self.policy, "hazard", None)
        self.hazard_estimator: Optional[HazardEstimator] = (
            HazardEstimator(hz_cfg) if hz_cfg else None)
        self.lifecycle: Optional[LifecycleManager] = None
        if lc_cfg:
            self.lifecycle = LifecycleManager(
                cfg=lc_cfg,
                probe_fn=lambda d: self.cluster.devices[d].effective,
                hazard=self.hazard_estimator)
        # pooled domain-level detection (default-off ``domains`` switch):
        # the estimator aggregates the lifecycle's FailureHistory by
        # failure domain — whole-domain quarantine + domain-spread risk.
        # ``domains`` implies ``hazard`` implies ``lifecycle`` (policy
        # __post_init__), so the manager above always exists here.
        dom_cfg = getattr(self.policy, "domains", None)
        self.domain_estimator: Optional[DomainEstimator] = (
            DomainEstimator(dom_cfg) if dom_cfg else None)
        self._domain_members: Optional[dict] = None
        # per-domain time of the last quarantine-supporting evidence: a
        # benched domain stays benched for ``hold_s`` after this (benching
        # works precisely by silencing the evidence stream, so a purely
        # window-functional quarantine would flap)
        self._domain_trips: dict = {}
        if dom_cfg:
            members: dict = {}
            for d in range(self.topo.n_devices):
                members.setdefault(
                    self.topo.domain_of(d, dom_cfg.domain), []).append(d)
            self._domain_members = members
        # unified credit score (default-off ``credit`` switch): one scalar
        # per device behind quarantine, admission and placement. ``credit``
        # implies ``hazard`` implies ``lifecycle`` (policy __post_init__),
        # so the manager and estimator above always exist here; the model
        # attaches to the manager, which rekeys its decision chain on the
        # credit bands.
        cr_cfg = getattr(self.policy, "credit", None)
        self.credit_model: Optional[CreditModel] = None
        if cr_cfg:
            cr_members = None
            if cr_cfg.delta > 0.0:
                cr_members = {}
                for d in range(self.topo.n_devices):
                    cr_members.setdefault(
                        self.topo.domain_of(d, cr_cfg.domain), []).append(d)
            self.credit_model = CreditModel(
                cr_cfg, self.topo.n_devices,
                hazard=self.hazard_estimator, domain_members=cr_members)
            if self.lifecycle is not None:
                self.lifecycle.credit = self.credit_model
            # the planner owns the NTP veto, so it owns the veto counter
            sched = getattr(self.policy, "scheduler", None)
            if sched is not None and hasattr(sched, "credit_stats"):
                sched.credit_stats = self.credit_model.stats
        # validation doubles as a fail-stop path (lifecycle gate): a
        # validation pass reports devices it measured dead instead of
        # leaving them to the heartbeat timeout
        self._validation_failstop = bool(lc_cfg and lc_cfg.validation_failstop)

        dkw = dict(detector_kwargs or {})
        dkw.setdefault("workload_filter", policy_name.lower() == "resihp")
        if lc_cfg:
            dkw.setdefault("suppress_failstop_s", lc_cfg.failstop_suppress_s)
            # the debounce hold is the second hand-tuned lifecycle constant
            # retired into the credit fit (4.0 stays the credit-off default)
            dkw.setdefault("validation_debounce_s",
                           cr_cfg.validation_debounce_s if cr_cfg
                           else lc_cfg.validation_debounce_s)
        # a fitted threshold of 1.0 means the margin is unclearable — no
        # shortfall is < 100% slow — so the whole slope/carry stack would be
        # pure overhead; skip installing it and let the credit gamma term be
        # the only slowness channel
        drift_on = bool(lc_cfg and lc_cfg.drift
                        and not (cr_cfg
                                 and cr_cfg.drift_filter_threshold >= 1.0))
        if drift_on:
            dkw.setdefault("drift_factory", SlopeDriftDetector)
            dkw.setdefault("carry_baseline", True)
            # the hand-tuned 10% validation margin is retired as a fit
            # output under the credit switch (0.10 stays the credit-off
            # default via LifecycleConfig)
            dkw.setdefault("drift_filter_threshold",
                           cr_cfg.drift_filter_threshold if cr_cfg
                           else lc_cfg.drift_filter_threshold)
            dkw.setdefault("workload_scalar_fn", self._workload_scalar)
        self.detector = Detector(
            healthy_time_fn=self._healthy_time,
            validate_fn=self._validate,
            heartbeat=hb,
            changepoint_factory=lambda: CusumDetector(warmup=10),
            **dkw,
        )
        # vectorized belief->stage-speed sync (fast engine only; the python
        # engine keeps the reference per-device loop as the parity anchor)
        self._stage_speed_cache = StageSpeedCache() if engine == "fast" else None
        # cached liveness vector for the vectorized heartbeat path; rebuilt
        # lazily, keyed on the registry's mutation counter (liveness changes
        # flow exclusively through ClusterState mutators, which bump it)
        self._alive_vec = None
        self._alive_version = -1
        # the system's *belief* about device speeds (truth lives in cluster)
        self.known_speeds = BeliefArray(self.topo.n_devices)
        self._belief_dirty = True
        self._decision: Optional[PolicyDecision] = None
        self._failslow_backlog: list = []  # (device, true_speed, detect_at_iter)
        self._probation: set = set()  # devices with an active re-probe chain
        self.trace: list = []
        self.now = 0.0
        self.it = 0
        self.aborted = False
        # min-heap of (Event, seq): scenario timelines merge in O(log n) and
        # pop in the same order the previous sorted-list representation
        # produced (full Event field order, insertion order on exact ties)
        self.pending_events: list = []
        self._event_seq = 0
        self.event_log: list = []  # Events already applied, in firing order

    # ------------------------------------------------------------ predictor
    def _fit_predictor(self) -> MicroBatchTimePredictor:
        """Warm-up profiling: fit Eq. 1 on healthy synthetic chunks."""
        cfg = self.cfg
        pred = MicroBatchTimePredictor(backward_ratio=cfg.b_ratio,
                                       weight_ratio=cfg.w_ratio)
        for i in range(24):
            w = self.gen.for_iteration(10_000 + i)
            mb = w.per_replica[0][0]
            t = (cfg.alpha * mb.n_tokens + cfg.beta * mb.sum_l2 + cfg.gamma)
            pred.observe(mb.n_tokens, mb.sum_l2, t, n_layers=1)
        return pred.fit()

    def _healthy_time(self, workload) -> float:
        """Eq. 2: expected healthy iteration time for this workload under the
        current plan — DAG critical path with predicted chunk times."""
        decision = self._decision
        plan = decision.plan if decision else self.plan0
        share = self._stage_shares(plan)

        def cost(cid: ChunkId, executor=None) -> float:
            mbw = workload.stats(cid.replica, cid.mb)
            return self._fitted.predict(
                mbw.n_tokens, mbw.sum_l2,
                n_layers=share[cid.stage] * len(self.layer_costs),
                kind=cid.kind,
            )

        m = self._migrator_cls(
            n_stages=plan.replicas[0].pp, n_replicas=plan.dp,
            n_microbatches=decision.n_mb if decision else plan.microbatches,
            chunk_cost=cost, schedule=self.cfg.schedule, policy="none",
            p2p_cost=self.cfg.p2p_cost,
        )
        r = m.run()
        return r.makespan if r.status == "ok" else float("inf")

    def _workload_scalar(self, workload) -> float:
        """Cheap Eq. 1 workload proxy (total predicted chunk seconds, no DAG
        critical path): normalizes the drift test's input so per-iteration
        workload swings don't mask a slow ramp's trend."""
        tot = 0.0
        for mbs in workload.per_replica:
            for mb in mbs:
                tot += self._fitted.predict(mb.n_tokens, mb.sum_l2)
        return tot

    def _validate(self, iteration: int) -> list:
        """Validation phase: localize degraded devices (ground-truth lookup —
        Greyhound's micro-benchmark pass; the cost is charged by Detector).
        With the lifecycle's ``validation_failstop`` gate, devices the pass
        measures *dead* are reported too (speed 0.0) — the fail-stop no
        longer waits out the heartbeat window when a validation already ran.

        One masked comparison of the registry's effective-speed array
        against the belief mirror (``known_speeds.arr``) replaces the
        reference O(n) dict walk; ``np.nonzero`` preserves the ascending
        device-id report order, and a dead device's effective speed is
        exactly the 0.0 the reference appended."""
        eff = self.cluster.effective()
        alive = self.cluster.alive_mask()
        known = self.known_speeds.arr
        mask = alive & (eff < 0.97) & (known > eff)
        if self._validation_failstop:
            mask = mask | (~alive & (known > 0.0))
        return [(int(d), float(eff[d])) for d in np.nonzero(mask)[0]]

    # ------------------------------------------------------------- helpers
    def _stage_shares(self, plan, replica: int = 0) -> dict:
        total = sum(self.layer_costs)
        shares = {}
        for s, st in enumerate(plan.replicas[replica].stages):
            shares[s] = sum(self.layer_costs[i] for i in st.layers) / total
        return shares

    def _true_stage_speeds(self, plan) -> dict:
        """Effective speed of each (replica, stage) group under TRUE device
        state: (k/tp0) * min p over the group; 0 if any member is dead. A
        stage running nonuniform shard widths (NTP) instead pays each
        member's width over its speed — NTP_EFFICIENCY / (tp0 * max f_i/p_i)
        — so a well-matched width assignment realizes ~sum(p_i)."""
        tp0 = self.cfg.tp
        if self._stage_speed_cache is not None:
            # fast engine: reduce over the registry's cached effective array,
            # memoized on (plan, cluster version) — quiet iterations skip the
            # recompute entirely
            return self._stage_speed_cache.speeds(
                plan, self.cluster.effective(), tp0,
                version=self.cluster.version)
        speeds = self.cluster.speeds()
        out = {}
        for r, rep in enumerate(plan.replicas):
            for s, st in enumerate(rep.stages):
                if not st.devices:
                    out[(r, s)] = 0.0
                    continue
                vals = [speeds.get(d, 0.0) for d in st.devices]
                if min(vals) <= 0:
                    out[(r, s)] = 0.0
                elif st.shard_fractions is not None:
                    worst = max(f / v for f, v in zip(st.shard_fractions, vals))
                    out[(r, s)] = NTP_EFFICIENCY / (tp0 * worst)
                else:
                    out[(r, s)] = (st.tp / tp0) * min(vals)
        return out

    # ------------------------------------------------------------ schedule
    def apply_scenario(self, scenario, *, seed: Optional[int] = None,
                       validate: bool = True):
        """Compile a FailureScenario (or registry name) against this sim's
        topology and enqueue its event timeline. Returns the compiled trace.

        ``validate`` (default on) rejects contradictory timelines — rejoins
        of never-failed devices, events on out-of-range ids, double kills —
        with a :class:`~repro_torch.cluster.events.TraceValidationError` instead
        of silently mis-simulating them; pass ``validate=False`` to replay
        a deliberately malformed trace."""
        from repro_torch.cluster.scenarios import FailureScenario, get as get_scenario

        if isinstance(scenario, str):
            scenario = get_scenario(scenario)
        assert isinstance(scenario, FailureScenario), scenario
        trace = scenario.compile(
            self.topo, self.cfg.seed if seed is None else seed)
        if validate:
            trace.validate(self.topo)
        for ev in trace:
            self._push_event(ev)
        return trace

    def _push_event(self, ev: Event):
        heapq.heappush(self.pending_events, (ev, self._event_seq))
        self._event_seq += 1

    def inject_at(self, time_s: float, fn: Callable):
        """Legacy shim: fn(cluster, now) applied once simulated time passes
        time_s. Prefer apply_scenario with a declarative FailureScenario."""
        self._push_event(Event(float(time_s), "callback", fn=fn))

    def _on_rejoin(self, device: int):
        """Elastic rejoin: the repaired device announces itself. Without the
        lifecycle subsystem the belief flips to full health (the paper's
        model — wrong when the device comes back degraded); with it, a flap
        quarantine can absorb the rejoin entirely and the admission probe
        seeds the belief with the *measured* speed."""
        if self.lifecycle is not None:
            dec = self.lifecycle.on_rejoin(device, self.now)
            async_probe = (self.credit_model is not None
                           and self.credit_model.cfg.admission)
            if async_probe:
                # asynchronous admission (credit switch): the probe runs on
                # the rejoining device itself — which is idle anyway — and
                # overlaps the replan this very rejoin triggers, so no
                # global time is charged; the measured speed still seeds
                # the belief (the whole point of admission probing)
                if dec.admit and dec.probe_cost_s > 0.0:
                    self.credit_model.stats.async_admissions += 1
            else:
                self.now += dec.probe_cost_s
            if not dec.admit:
                # quarantined: belief stays failed, heartbeat stays muted, no
                # replan — the Scheduler keeps ignoring the flapper
                return
            speed = dec.speed
            if (async_probe and dec.probe_cost_s > 0.0 and speed < 1.0
                    and self.credit_model.cfg.probation_recheck_s > 0.0):
                # a degraded admission starts probation: nothing else ever
                # re-measures a device the planner benched on this stale
                # reading, so a transient throttle would pin it slow forever
                self._schedule_probation(device)
        else:
            speed = 1.0
        # heartbeat-revive bugfix: clear the failed state so the device's
        # *next* fail-stop is detectable (previously never cleared)
        self.detector.heartbeat.revive(device, self.now)
        if self.known_speeds.get(device) != speed:
            self.known_speeds[device] = speed
            self._belief_dirty = True

    def _schedule_probation(self, device: int):
        """Queue a free async re-probe of ``device`` one recheck interval
        out; the re-probe keeps following the device (and rescheduling)
        until belief matches truth or the device fails again. At most one
        chain runs per device."""
        if device in self._probation:
            return
        self._probation.add(device)
        recheck_s = self.credit_model.cfg.probation_recheck_s

        def fn(cluster, now):
            believed = self.known_speeds.get(device, 1.0)
            true = cluster.devices[device].effective
            if believed <= 0.0 or true <= 0.0:
                # failed again / down right now: the next rejoin or
                # validation restarts probation
                self._probation.discard(device)
                return
            if true != believed:
                self.known_speeds[device] = true
                self._belief_dirty = True
                self.credit_model.stats.probation_corrections += 1
                self._push_event(Event(self.now + recheck_s, "callback",
                                       fn=fn))
            else:
                self._probation.discard(device)

        self._push_event(Event(self.now + recheck_s, "callback", fn=fn))

    def apply_events(self, t: float) -> list:
        """The single injection hook: fire every pending event with
        ``event.t <= t`` against the cluster (and system beliefs, for
        rejoins), appending them to ``event_log``."""
        fired = []
        while self.pending_events and self.pending_events[0][0].t <= t:
            ev = heapq.heappop(self.pending_events)[0]
            apply_event(ev, self.cluster, self.now, on_rejoin=self._on_rejoin)
            self.event_log.append(ev)
            fired.append(ev)
        return fired

    def _expected_time(self, workload, decision) -> float:
        """Expected *observed* iteration time under ``decision``: Eq. 2
        critical path with predicted chunk times divided by the decision's
        believed per-stage effective speeds. Unlike ``_healthy_time`` (the
        workload filter's healthy reference) this includes the slowdowns the
        system already knows about — the right scale for carrying the CUSUM
        baseline across a reconfiguration, since the post-reconfig steady
        state is legitimately slower than healthy whenever a mitigated
        degradation remains."""
        plan = decision.plan
        share = self._stage_shares(plan)
        speeds = decision.stage_speeds

        def cost(cid: ChunkId, executor=None) -> float:
            mbw = workload.stats(cid.replica, cid.mb)
            base = self._fitted.predict(
                mbw.n_tokens, mbw.sum_l2,
                n_layers=share[cid.stage] * len(self.layer_costs),
                kind=cid.kind,
            )
            v = speeds.get((cid.replica, cid.stage), 1.0)
            return base / max(v, 1e-9)

        m = self._migrator_cls(
            n_stages=plan.replicas[0].pp, n_replicas=plan.dp,
            n_microbatches=decision.n_mb, chunk_cost=cost,
            schedule=self.cfg.schedule, policy="none",
            p2p_cost=self.cfg.p2p_cost,
        )
        r = m.run()
        return r.makespan if r.status == "ok" else float("inf")

    def _domain_view(self, now: float):
        """Pooled domain-level failure view at ``now``: the set of devices
        resident in quarantined domains, plus per-device pooled risk for
        every elevated (but not necessarily quarantined) domain. The view is
        functional in the lifecycle's histories and ``now`` except for the
        quarantine hold: once a domain trips, it stays benched for
        ``hold_s`` after its last supporting evidence (``_domain_trips``),
        because benching silences the very evidence stream that tripped it
        — without the hold the quarantine flaps, and every flap is a full
        replan with migrations. Both engines run this identically from the
        shared step loop, so the extra state cannot diverge them."""
        est = self.domain_estimator
        cfg = est.cfg
        hist = self.lifecycle.histories
        quarantined: set = set()
        risk: dict = {}
        for dom in sorted(self._domain_members):
            members = self._domain_members[dom]
            hs = [hist[d] for d in members if d in hist]
            held = (dom in self._domain_trips
                    and now < self._domain_trips[dom] + cfg.hold_s)
            if not hs and not held:
                continue
            r = est.risk(hs, now) if hs else 1.0
            if cfg.quarantine and hs and est.should_quarantine(hs, now):
                self._domain_trips[dom] = now
                held = True
            if cfg.quarantine and held:
                quarantined.update(members)
            if cfg.spread and r > 1.0:
                for d in members:
                    risk[d] = r
        return frozenset(quarantined), risk

    def _rebaseline_scale(self, old_decision) -> Optional[float]:
        """Predicted expected-time ratio (new decision / old decision) for
        the ramp-aware baseline carry. Only computed when the Detector will
        use it (lifecycle drift policy on) — two extra Eq. 2 critical-path
        evaluations per reconfiguration; ``None`` otherwise, which makes
        ``rebaseline`` behave exactly as before (full reset)."""
        if (not self.detector.carry_baseline or old_decision is None
                or old_decision.aborted or self._decision.aborted):
            return None
        w = self.gen.for_iteration(self.it)
        h_new = self._expected_time(w, self._decision)
        h_old = self._expected_time(w, old_decision)
        if not (math.isfinite(h_old) and math.isfinite(h_new)) or h_old <= 0:
            return None
        return h_new / h_old

    # ------------------------------------------------------------ stepping
    def _sync_beliefs(self) -> list:
        """Detection: heartbeats catch fail-stop immediately; fail-slow is
        detected via the Detector's series analysis with latency."""
        events = []
        # quarantine releases: probe expired quarantines and readmit (or
        # extend the backoff for devices that are still down)
        if self.lifecycle is not None:
            release_free = (self.credit_model is not None
                            and self.credit_model.cfg.admission)
            for dec in self.lifecycle.poll_releases(self.now):
                if not release_free:
                    # under the credit switch the release probe runs on the
                    # still-benched device concurrently with training, like
                    # the rejoin probe — no global charge
                    self.now += dec.probe_cost_s
                if not dec.admit:
                    continue
                self.detector.heartbeat.revive(dec.device, self.now)
                if self.known_speeds.get(dec.device) != dec.speed:
                    self.known_speeds[dec.device] = dec.speed
                    self._belief_dirty = True
                events.append(("readmitted", (dec.device, dec.speed)))
        # fail-stop: heartbeat sweep (dead devices stopped beating). The fast
        # engine beats the whole fleet in one vectorized call; the python
        # engine keeps the reference per-device loop as the parity anchor.
        if isinstance(self.detector.heartbeat, FastHeartbeat):
            if self._alive_version != self.cluster.version:
                self._alive_vec = self.cluster.alive_mask()
                self._alive_version = self.cluster.version
            self.detector.heartbeat.beat_all(self._alive_vec, self.now)
        else:
            for d, dev in self.cluster.devices.items():
                if dev.alive:
                    node = self.topo.node_of(d)
                    self.detector.heartbeat.device_beat(node, d, self.now, self.it)
                    self.detector.heartbeat.node_beat(node, self.now)
        # dead nodes stop beating entirely
        rep = self.detector.poll_failstop(self.now)
        if rep:
            for d in rep.devices:
                if self.lifecycle is not None:
                    self.lifecycle.record_failstop(d, self.now)
                if self.known_speeds.get(d, 1.0) != 0.0:
                    self.known_speeds[d] = 0.0
                    self._belief_dirty = True
            events.append(("fail-stop-detected", rep.devices))
            # the stall models an NCCL timeout: only a rank inside an
            # active communicator can hang a collective. A death confined
            # to warm standbys (benched rack, hazard-quarantined device) is
            # detected out-of-band by the heartbeat — belief flips above,
            # but training never stalls. Membership gating rides the
            # domains= switch: with it off, every fail-stop charges the
            # stall exactly as before (old sweep cells stay byte-identical).
            stall = True
            if self.domain_estimator is not None:
                active = None
                if self._decision is not None and not self._decision.aborted:
                    active = frozenset(
                        d for r in self._decision.plan.replicas
                        for d in r.devices)
                stall = (active is None
                         or any(d in active for d in rep.devices))
            if stall:
                self.now += self.cfg.failstop_stall_s
        # fail-slow backlog promoted after detect latency
        still = []
        for d, speed, at in self._failslow_backlog:
            if self.it >= at:
                if self.known_speeds.get(d, 1.0) != speed:
                    self.known_speeds[d] = speed
                    self._belief_dirty = True
                    events.append(("fail-slow-detected", (d, speed)))
                    if self.lifecycle is not None:
                        self.lifecycle.record_failslow(d, speed, self.now)
            else:
                still.append((d, speed, at))
        self._failslow_backlog = still
        return events

    def step(self) -> IterRecord:
        cfg = self.cfg
        events = []
        events += [("injection", ev.t) for ev in self.apply_events(self.now)]
        events += self._sync_beliefs()

        if self._belief_dirty or self._decision is None:
            changed = self._decision is not None and self._belief_dirty
            old_decision = self._decision
            excluded = (self.lifecycle.quarantined(self.now)
                        if self.lifecycle is not None else frozenset())
            # per-device hazard view for risk-aware placement ({} -> None:
            # the hazard-blind planner path stays byte-identical)
            risk = (self.lifecycle.risk_scores(self.now)
                    if self.lifecycle is not None else {})
            # unified credit view for placement / restart weighting (None
            # when the switch is off — the credit-blind path stays
            # byte-identical)
            credit_scores = None
            if (self.credit_model is not None
                    and self.credit_model.cfg.planning):
                credit_scores = self.credit_model.scores(
                    self.lifecycle.histories, self.now) or None
                # one scalar means ONE: the raw hazard view is dropped, not
                # merged — risk only reaches placement through the credit
                # score's alpha term. Without this, a zero-signal credit
                # config would still pay the risk view's plan-cache churn.
                risk = {}
            if self.domain_estimator is not None:
                # pooled domain view: a hot domain's residents are excluded
                # wholesale (bench the rack before its third device fails)
                # and carry the pooled risk into placement tie-breaks
                dq, drisk = self._domain_view(self.now)
                if dq:
                    excluded = frozenset(excluded) | dq
                if drisk:
                    risk = dict(risk)
                    for d, rv in drisk.items():
                        if rv > risk.get(d, 1.0):
                            risk[d] = rv
            self._decision = self.policy.decide(self.known_speeds,
                                                changed=changed,
                                                excluded=excluded,
                                                risk=risk or None,
                                                credit=credit_scores)
            if (self._decision.aborted and self.domain_estimator is not None
                    and dq):
                # a bench is advisory, never fatal: if excluding the hot
                # domain leaves no feasible plan (its capacity is needed to
                # cover unrelated concurrent failures), fall back to the
                # per-device exclusion set and keep the session alive
                excluded = frozenset(excluded) - dq
                self._decision = self.policy.decide(self.known_speeds,
                                                    changed=changed,
                                                    excluded=excluded,
                                                    risk=risk or None,
                                                    credit=credit_scores)
                events.append(("bench-waived", tuple(sorted(dq))))
            self._belief_dirty = False
            if self._decision.reconfig_overhead_s:
                self.now += self._decision.reconfig_overhead_s
                events.append(("reconfig", self._decision.reconfig_overhead_s))
                self.detector.rebaseline(self._rebaseline_scale(old_decision))
        decision = self._decision
        if decision.aborted:
            self.aborted = True
            rec = IterRecord(self.it, self.now, math.inf, 0.0,
                             events + [("aborted", decision.detail)])
            self.trace.append(rec)
            return rec

        workload = self.gen.for_iteration(self.it)
        plan = decision.plan
        true_speed = self._true_stage_speeds(plan)
        # dense (replica, stage) mirror of true_speed for the fast engine's
        # batched cost gather; only valid while it matches the dict
        speed_grid = (self._stage_speed_cache.grid
                      if self._stage_speed_cache is not None else None)
        if decision.slowdown_recovery > 0.0:
            # schedule-level mitigation (Adaptra): hides part of a slowdown
            true_speed = {
                e: (v + (1.0 - v) * decision.slowdown_recovery if 0.0 < v < 1.0 else v)
                for e, v in true_speed.items()
            }
            speed_grid = None
        # ZB splits the 1F1B backward into B (activation) + W (weight): the
        # two must sum to the 1F1B backward cost, not add to it
        if decision.schedule.lower().startswith("zb"):
            mult = {"F": 1.0, "B": cfg.b_ratio - cfg.w_ratio, "W": cfg.w_ratio}
        else:
            mult = {"F": 1.0, "B": cfg.b_ratio, "W": cfg.w_ratio}
        jit = float(self.rng.normal(1.0, cfg.noise)) if cfg.noise else 1.0

        def make_cost(share, replica_map=None):
            if self.engine == "fast":
                # vectorized per-(stage, kind, micro-batch) cost arrays,
                # bit-identical to the scalar closure below
                return make_cost_table(
                    alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma,
                    workload=workload, share=share,
                    n_layers=len(self.layer_costs), mult=mult, jit=jit,
                    true_speed=true_speed, replica_map=replica_map,
                    true_speed_grid=speed_grid)

            def cost(cid: ChunkId, executor) -> float:
                r = replica_map(cid.replica) if replica_map else cid.replica
                mbw = workload.stats(r, cid.mb)
                base = (cfg.alpha * mbw.n_tokens + cfg.beta * mbw.sum_l2 + cfg.gamma)
                base *= share[cid.stage] * len(self.layer_costs) * mult[cid.kind]
                e = (r, executor[1]) if replica_map else executor
                v = true_speed.get(e, 1.0)
                return base * jit / max(v, 1e-9)
            return cost

        dead = [e for e, v in true_speed.items() if v <= 0.0]
        if decision.migration_policy == "none":
            # replicas may be heterogeneous (Oobleck templates): simulate each
            # pipeline independently; the iteration ends at the DP sync = max.
            res = self._run_independent(decision, make_cost, dead)
        else:
            share = self._stage_shares(plan)
            m = self._migrator_cls(
                n_stages=plan.replicas[0].pp,
                n_replicas=plan.dp,
                n_microbatches=decision.n_mb,
                chunk_cost=make_cost(share),
                schedule=decision.schedule,
                dead_executors=dead,
                policy=decision.migration_policy,
                delta=decision.delta,
                p2p_cost=cfg.p2p_cost,
                migrate_edge_cost=cfg.migrate_edge_cost,
            )
            res = m.run()
        if res.status != "ok":
            # undetected dead executor stalls the job until detection kicks in
            self.aborted = decision.migration_policy == "none" and bool(
                set(dead) & set(plan.dead_stages or ())
            )
            duration = cfg.failstop_stall_s
            rec = IterRecord(self.it, self.now, duration, 0.0,
                             events + [("stalled", res.detail)])
        else:
            duration = res.makespan * (1.0 + cfg.detector_tax)
            thpt = cfg.samples_per_iter / duration
            rec = IterRecord(self.it, self.now, duration, thpt,
                             events + [("migrations", len(res.migrations))] if res.migrations else events)

        # fail-slow series detection on the observed time (real Detector) —
        # only systems with a fail-slow story run it (vanilla ReCycle/Oobleck
        # have no detector; their belief stays healthy, execution stays slow)
        if self.policy.handles_failslow and not math.isinf(rec.duration):
            drep = self.detector.observe_iteration(self.it, rec.duration, workload, self.now)
            if drep:
                for d, speed in drep.devices:
                    if speed <= 0.0:
                        # validation doubled as the fail-stop path: the pass
                        # measured the device dead, so the belief flips now —
                        # no heartbeat wait, no second NCCL-stall charge (the
                        # monitor is told out-of-band so its sweep stays mute,
                        # and the Detector arms its fail-stop suppression
                        # window exactly as for a heartbeat detection)
                        self.detector.heartbeat.mark_failed(d)
                        self.detector.note_failstop(self.now)
                        if self.lifecycle is not None:
                            self.lifecycle.record_failstop(d, self.now)
                        if self.known_speeds.get(d, 1.0) != 0.0:
                            self.known_speeds[d] = 0.0
                            self._belief_dirty = True
                        rec.events.append(("failstop-via-validation", d))
                    else:
                        self._failslow_backlog.append(
                            (d, speed, self.it + cfg.failslow_detect_iters - 1))
                rec.events.append(("failslow-report", drep.devices))

        self.now += rec.duration if not math.isinf(rec.duration) else 0.0
        self.it += 1
        self.trace.append(rec)
        return rec

    def _run_independent(self, decision, make_cost, dead):
        """Per-replica pipeline simulation for non-migrating policies; the
        iteration ends at the global DP synchronization (max over replicas)."""
        from repro_torch.core.scheduler.migration import SimResult

        plan = decision.plan
        worst, finishes = 0.0, {}
        all_ok = True
        detail = ""
        for r, rep in enumerate(plan.replicas):
            if decision.n_mb[r] <= 0:
                continue
            share = self._stage_shares(plan, r)
            dead_r = [(0, s) for (dr, s) in dead if dr == r and s < rep.pp]
            m = self._migrator_cls(
                n_stages=rep.pp, n_replicas=1,
                n_microbatches=[decision.n_mb[r]],
                chunk_cost=make_cost(share, replica_map=lambda _=None, r=r: r),
                schedule=decision.schedule,
                dead_executors=dead_r,
                policy="none",
                p2p_cost=self.cfg.p2p_cost,
            )
            res_r = m.run()
            if res_r.status != "ok":
                all_ok = False
                detail = res_r.detail
                continue
            worst = max(worst, res_r.makespan)
            finishes[r] = res_r.makespan
        if not all_ok:
            return SimResult(math.inf, "aborted", {}, [], {}, finishes, detail=detail)
        return SimResult(worst, "ok", {}, [], {}, finishes)

    def run(self, n_iters: int, *, stop_on_abort=True) -> list:
        for _ in range(n_iters):
            rec = self.step()
            if self.aborted and stop_on_abort:
                break
        return self.trace

    # ------------------------------------------------------------- metrics
    def avg_throughput(self, *, skip: int = 0) -> float:
        """Execution throughput: samples/s over iteration durations only —
        reconfiguration, stall and probe charges advance ``now`` but are not
        part of any iteration, so this metric ignores them (the paper's
        figure convention)."""
        recs = [r for r in self.trace[skip:] if not math.isinf(r.duration)]
        if not recs:
            return 0.0
        total_t = sum(r.duration for r in recs)
        total_s = sum(r.throughput * r.duration for r in recs)
        return total_s / max(total_t, 1e-9)

    def session_throughput(self, *, skip: int = 0) -> float:
        """End-to-end throughput: samples delivered per second of *elapsed*
        simulated time, reconfiguration / fail-stop-stall / probe charges
        included. This is the metric a reconfiguration storm actually hurts
        — the one the failure-lifecycle and hazard policies optimize."""
        recs = [r for r in self.trace[skip:] if not math.isinf(r.duration)]
        if not recs:
            return 0.0
        t0 = recs[0].t_start
        elapsed = max(self.now - t0, 1e-9)
        total_s = sum(r.throughput * r.duration for r in recs)
        return total_s / elapsed
