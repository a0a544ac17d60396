"""Resilience policies: ResiHP and the paper's four baselines (§8.1).

Each policy maps the current failure state (device speeds) to a
PolicyDecision: the plan to execute, per-(replica,stage) effective speeds,
the DP migration mode, per-replica micro-batch counts, and the
reconfiguration overhead to charge. The simulator executes decisions; the
differences between systems are exactly the paper's §3 limitations:

  ReCycle      — fail-stop only. A failed device excludes its *entire* TP
                 group (no selective exclusion); pending work is rerouted to
                 DP peers with no progress awareness (Fig. 3a/6a). No
                 fail-slow reaction. Aborts when a stage loses all replicas.
  Oobleck      — fail-stop only. Switches the affected replica to a
                 precomputed template with fewer stages (layers merged into
                 survivors); high reconfiguration latency; aborts beyond its
                 precomputed fault budget. No fail-slow reaction.
  Greyhound    — fail-slow only. Change-point detection *without* the
                 workload filter (pays validation on every alarm) and
                 mitigates by redistributing micro-batches across DP groups
                 proportionally to replica speed (Fig. 3b: intra-DP pipeline
                 imbalance remains).
  Adaptra      — fail-slow only. PP-schedule adaptation: ZB-H1 with
                 bubble-filling hides part of a slow stage; communication
                 slowdowns are largely overlapped. No DP redistribution.
  strengthened ReCycle/Oobleck — + Greyhound's fail-slow handling (§8.1).
  ResiHP       — full §6 progressive adaptation via the Scheduler.

A copy of `repro.cluster.baselines`, kept whole here, without importing
the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.scheduler.plan import ParallelPlan, ReplicaPlan, StagePlan, initial_plan
from repro_torch.core.scheduler.scheduler import PlanOverheadModel, Scheduler


@dataclass
class PolicyDecision:
    plan: ParallelPlan
    stage_speeds: dict  # (replica, stage) -> effective speed (1.0 healthy)
    migration_policy: str  # 'resihp' | 'recycle' | 'none'
    n_mb: list  # per replica
    reconfig_overhead_s: float
    aborted: bool = False
    delta: int = 1
    schedule: str = "1f1b"
    detail: str = ""
    # share of a fail-slow slowdown genuinely hidden by the policy's schedule
    # adaptation (Adaptra's async-P2P/bubble-filling) — applied to execution
    slowdown_recovery: float = 0.0

    @property
    def dead_executors(self):
        return self.plan.dead_stages


def _group_speed_conservative(devices, speeds) -> float:
    """Baseline TP-group speed: no selective exclusion — a fail-stop device
    kills the group (0.0); otherwise the group runs at its slowest member."""
    vals = [speeds.get(d, 1.0) for d in devices]
    if any(v <= 0.0 for v in vals):
        return 0.0
    return min(vals)


def _redistribute_mb(total_mb: int, replica_speeds: list) -> list:
    """Greyhound-style: micro-batches proportional to replica speed."""
    s = [max(v, 0.0) for v in replica_speeds]
    tot = sum(s)
    if tot <= 0:
        return [0] * len(s)
    raw = [v / tot * total_mb for v in s]
    out = [int(x) for x in raw]
    # distribute remainder to largest fractional parts, keep >=1 for live reps
    rem = total_mb - sum(out)
    order = sorted(range(len(s)), key=lambda i: raw[i] - out[i], reverse=True)
    for i in range(rem):
        out[order[i % len(order)]] += 1
    for i, v in enumerate(s):
        if v > 0 and out[i] == 0:
            j = max(range(len(out)), key=lambda k: out[k])
            out[j] -= 1
            out[i] += 1
    return out


@dataclass
class BasePolicy:
    plan0: ParallelPlan
    layer_costs: list
    handles_failslow: bool = False
    handles_failstop: bool = False
    name: str = "base"
    reconfig_cost_s: float = 5.0

    def _replica_bottleneck_speed(self, plan, stage_speeds, r) -> float:
        pp = plan.replicas[r].pp
        vals = [stage_speeds.get((r, s), 0.0) for s in range(pp)]
        return min(vals) if vals else 0.0

    def decide(self, speeds, *, changed: bool,
               excluded=frozenset(), risk=None,
               credit=None) -> PolicyDecision:
        """``excluded``: lifecycle-quarantined devices; ``risk``: per-device
        hazard scores from the lifecycle hazard estimator; ``credit``:
        per-device unified credit scores (supersede ``risk`` when present).
        Only policies with a failure-lifecycle story (ResiHP) act on any of
        them — baselines ignore them, mirroring their lack of flap/hazard
        memory (§3 limitations)."""
        raise NotImplementedError


@dataclass
class ReCyclePolicy(BasePolicy):
    name: str = "recycle"
    handles_failstop: bool = True
    failslow_aware: bool = False  # strengthened flag

    def __post_init__(self):
        self.handles_failslow = self.failslow_aware
        if self.failslow_aware:
            self.name = "recycle+"

    def decide(self, speeds, *, changed: bool,
               excluded=frozenset(), risk=None,
               credit=None) -> PolicyDecision:
        plan = self.plan0
        dead, stage_speeds = [], {}
        eff = dict(speeds)
        if not self.failslow_aware:
            pass  # slowdowns still physically apply; no reaction
        for r, rep in enumerate(plan.replicas):
            for s, st in enumerate(rep.stages):
                v = _group_speed_conservative(st.devices, eff)
                stage_speeds[(r, s)] = v
                if v <= 0.0:
                    dead.append((r, s))
        pp = plan.replicas[0].pp
        aborted = any(
            all((r, s) in dead for r in range(plan.dp)) for s in range(pp)
        )
        n_mb = [plan.microbatches] * plan.dp
        if self.failslow_aware:  # strengthened: Greyhound-style redistribution
            rep_speed = [
                min((stage_speeds[(r, s)] for s in range(pp)
                     if stage_speeds[(r, s)] > 0), default=0.0)
                or 1e-3
                for r in range(plan.dp)
            ]
            n_mb = _redistribute_mb(plan.microbatches * plan.dp, rep_speed)
        return PolicyDecision(
            plan=plan.replace(dead_stages=tuple(dead)),
            stage_speeds=stage_speeds,
            migration_policy="recycle",
            n_mb=n_mb,
            reconfig_overhead_s=self.reconfig_cost_s if changed else 0.0,
            aborted=aborted,
            detail="strengthened" if self.failslow_aware else "vanilla",
        )


@dataclass
class OobleckPolicy(BasePolicy):
    name: str = "oobleck"
    handles_failstop: bool = True
    failslow_aware: bool = False
    fault_budget_frac: float = 0.3  # precomputed templates cover this much loss
    reconfig_cost_s: float = 25.0  # template switch + state redistribution

    def __post_init__(self):
        self.handles_failslow = self.failslow_aware
        if self.failslow_aware:
            self.name = "oobleck+"

    def decide(self, speeds, *, changed: bool,
               excluded=frozenset(), risk=None,
               credit=None) -> PolicyDecision:
        plan0 = self.plan0
        pp = plan0.replicas[0].pp
        lost = sum(1 for d in plan0.devices if speeds.get(d, 1.0) <= 0.0)
        aborted = lost > self.fault_budget_frac * len(plan0.devices)

        # rebuild each replica: drop dead-TP-group stages, merge their layers
        new_replicas, stage_speeds = [], {}
        for r, rep in enumerate(plan0.replicas):
            alive_stages = [
                (s, st) for s, st in enumerate(rep.stages)
                if _group_speed_conservative(st.devices, speeds) > 0.0
            ]
            if not alive_stages:
                aborted = True
                new_replicas.append(rep)
                continue
            n_alive = len(alive_stages)
            # template: even contiguous re-split of all layers over survivors
            L = sum(st.n_layers for st in rep.stages)
            per = [L // n_alive + (1 if i < L % n_alive else 0) for i in range(n_alive)]
            off, stages = 0, []
            for i, (s, st) in enumerate(alive_stages):
                stages.append(StagePlan(st.devices, tuple(range(off, off + per[i]))))
                off += per[i]
            new_replicas.append(ReplicaPlan(tuple(stages)))
        # pad replicas to a uniform stage count for bookkeeping: speeds only
        for r, rep in enumerate(new_replicas):
            for s, st in enumerate(rep.stages):
                v = _group_speed_conservative(st.devices, speeds)
                # fewer stages => each stage holds more layers; fold the extra
                # work into the speed so bottleneck math stays comparable
                stage_speeds[(r, s)] = v * (len(rep.stages) / pp)
        plan = plan0.replace(replicas=tuple(new_replicas), dead_stages=())

        n_mb = [plan0.microbatches] * plan0.dp
        rep_speed = [
            self._replica_bottleneck_speed(plan, stage_speeds, r)
            for r in range(plan.dp)
        ]
        # Oobleck rebalances the global batch across heterogeneous pipelines
        n_mb = _redistribute_mb(plan0.microbatches * plan0.dp,
                                [v if v > 0 else 1e-3 for v in rep_speed])
        if not self.failslow_aware:
            # vanilla ignores fail-slow in its templates: redistribution keys
            # only on structure (stage counts), not on measured speeds
            struct_speed = [len(rep.stages) and pp / len(rep.stages) for rep in new_replicas]
            struct_speed = [1.0 / v if v else 0.0 for v in struct_speed]
            n_mb = _redistribute_mb(plan0.microbatches * plan0.dp,
                                    [v if v > 0 else 1e-3 for v in struct_speed])
        return PolicyDecision(
            plan=plan,
            stage_speeds=stage_speeds,
            migration_policy="none",
            n_mb=n_mb,
            reconfig_overhead_s=self.reconfig_cost_s if changed else 0.0,
            aborted=aborted,
            detail="strengthened" if self.failslow_aware else "vanilla",
        )


@dataclass
class GreyhoundPolicy(BasePolicy):
    name: str = "greyhound"
    handles_failslow: bool = True

    def decide(self, speeds, *, changed: bool,
               excluded=frozenset(), risk=None,
               credit=None) -> PolicyDecision:
        plan = self.plan0
        pp = plan.replicas[0].pp
        stage_speeds, dead = {}, []
        for r, rep in enumerate(plan.replicas):
            for s, st in enumerate(rep.stages):
                v = _group_speed_conservative(st.devices, speeds)
                stage_speeds[(r, s)] = v
                if v <= 0:
                    dead.append((r, s))
        aborted = bool(dead)  # no fail-stop story
        rep_speed = [
            min(stage_speeds[(r, s)] for s in range(pp)) for r in range(plan.dp)
        ]
        n_mb = _redistribute_mb(plan.microbatches * plan.dp,
                                [v if v > 0 else 1e-3 for v in rep_speed])
        return PolicyDecision(
            plan=plan.replace(dead_stages=tuple(dead)),
            stage_speeds=stage_speeds,
            migration_policy="none",
            n_mb=n_mb,
            reconfig_overhead_s=(self.reconfig_cost_s if changed else 0.0),
            aborted=aborted,
        )


@dataclass
class AdaptraPolicy(BasePolicy):
    name: str = "adaptra"
    handles_failslow: bool = True
    comm_recovery: float = 0.85  # share of a *network* slowdown hidden by
    # asynchronous P2P + schedule adaptation
    compute_recovery: float = 0.25  # ZB bubble-filling hides a bit of compute

    def decide(self, speeds, *, changed: bool,
               excluded=frozenset(), risk=None,
               credit=None) -> PolicyDecision:
        plan = self.plan0
        stage_speeds, dead = {}, []
        for r, rep in enumerate(plan.replicas):
            for s, st in enumerate(rep.stages):
                v = _group_speed_conservative(st.devices, speeds)
                if v <= 0:
                    dead.append((r, s))
                stage_speeds[(r, s)] = v
        return PolicyDecision(
            plan=plan.replace(dead_stages=tuple(dead)),
            stage_speeds=stage_speeds,
            migration_policy="none",
            n_mb=[plan.microbatches] * plan.dp,
            reconfig_overhead_s=(self.reconfig_cost_s if changed else 0.0),
            aborted=bool(dead),
            schedule="zb",
            slowdown_recovery=self.compute_recovery,
        )


@dataclass
class ResiHPPolicy(BasePolicy):
    name: str = "resihp"
    handles_failslow: bool = True
    handles_failstop: bool = True
    k_min: int = 1
    delta: int = 1
    group_rebuild_s: float = 1.8  # Fig. 13: comm-group reconstruction < 2s
    layer_transfer_s_per_layer: float = 0.35
    # None => charge measured wall-clock planning time (Fig. 13 methodology);
    # a float pins the charge for deterministic replay (golden tests)
    plan_overhead_fixed: Optional[float] = None
    # modeled planning-cost curve (PlanOverheadModel; ``True`` for the
    # checked-in default fit): deterministic *and* scale-aware, unlike the
    # measured charge (nondeterministic) or the fixed pin (a constant).
    # Resolution order: fixed > model > measured.
    plan_overhead_model: Optional[object] = None
    scheduler: Optional[Scheduler] = None
    # ablation switches (Fig. 11)
    enable_selective: bool = True
    enable_repartition: bool = True
    migration_mode: str = "resihp"  # 'resihp' | 'recycle' (progress-unaware)
    # failure-lifecycle policies (flap quarantine / ramp-aware drift / rejoin
    # admission — see repro_torch.core.detector.lifecycle). Default OFF: the paper's
    # one-shot failure model, bit-for-bit the pre-lifecycle behaviour. Pass
    # ``lifecycle=True`` for the default LifecycleConfig or a LifecycleConfig
    # for tuned/ablated policies; TrainingSim builds the manager from it.
    lifecycle: Optional[object] = None
    # per-device hazard awareness (HazardPolicyConfig; ``True`` for defaults;
    # default OFF): hazard-keyed quarantine backoff + risk-aware placement,
    # both fed by the lifecycle's FailureHistory — so enabling ``hazard``
    # turns the default lifecycle on if it was off.
    hazard: Optional[object] = None
    # nonuniform TP shard widths (NTPConfig; ``True`` for defaults; default
    # OFF): a mildly-slow device keeps a proportionally smaller shard
    # instead of being excluded — see tp_reconfig.shrink_shard_candidate.
    ntp: Optional[object] = None
    # correlated-failure-domain awareness (DomainPolicyConfig; ``True`` for
    # defaults; default OFF): pooled domain-level quarantine + domain-spread
    # placement risk + checkpoint/restart economics. Reads the same
    # FailureHistory records as the hazard estimator, so enabling
    # ``domains`` turns the default hazard (and therefore lifecycle)
    # switch on if it was off.
    domains: Optional[object] = None
    # unified device credit (CreditConfig; ``True`` loads the fitted weights
    # from src/repro_torch/configs/credit_fitted.json; default OFF): one learned
    # health scalar replaces the four hand-thresholded signals — quarantine
    # entry/backoff and probe admission key on credit bands, placement
    # tie-breaks take the credit vector (superseding device_risk), NTP
    # shrink-shard retention is credit-gated, and the restart-vs-adapt
    # decision weighs the plan's aggregate credit. The model reads the
    # hazard estimator's windowed risk, so enabling ``credit`` turns the
    # default hazard (and therefore lifecycle) switch on if it was off.
    credit: Optional[object] = None
    # physical topology (device -> node; TrainingSim wires topo.node_of) so
    # the Scheduler honors the §6.1 node-local-standby contract. None =>
    # plan-only use without a topology, whole-pool standby offers.
    node_of: Optional[object] = None
    # device -> failure-domain map (TrainingSim wires topo.pdu_of & co. when
    # ``domains`` is on): lets the Scheduler order standby offers toward
    # less-failed domains. None => legacy offer order, byte-identical.
    domain_of: Optional[object] = None

    def __post_init__(self):
        # the plan whose layers are currently resident on the devices — what
        # a reconfiguration's layer-transfer volume must be diffed against
        self._prev_plan = self.plan0
        if self.lifecycle is True:
            from repro_torch.core.detector.lifecycle import LifecycleConfig

            self.lifecycle = LifecycleConfig()
        if self.domains is True:
            from repro_torch.cluster.hazard import DomainPolicyConfig

            self.domains = DomainPolicyConfig()
        if self.domains:
            import dataclasses as _dc

            if self.domains.restart is True:
                from repro_torch.checkpoint import RestartCostModel

                self.domains = _dc.replace(self.domains,
                                           restart=RestartCostModel())
            if not self.hazard:
                self.hazard = True  # pooled detection rides on the same
                # FailureHistory evidence the per-device estimator keeps
        if self.credit is True:
            from repro_torch.core.detector.credit import fitted_credit_config

            self.credit = fitted_credit_config()
        if self.credit and not self.hazard:
            # the credit model's risk_excess signal is the hazard
            # estimator's windowed score
            self.hazard = True
        if self.hazard is True:
            from repro_torch.cluster.hazard import HazardPolicyConfig

            self.hazard = HazardPolicyConfig()
        if self.hazard and not self.lifecycle:
            from repro_torch.core.detector.lifecycle import LifecycleConfig

            self.lifecycle = LifecycleConfig()
        if self.plan_overhead_model is True:
            self.plan_overhead_model = PlanOverheadModel()
        if self.ntp is True:
            from repro_torch.core.scheduler.tp_reconfig import NTPConfig

            self.ntp = NTPConfig()
        if self.scheduler is None:
            self.scheduler = Scheduler(
                layer_costs=list(self.layer_costs), k_min=self.k_min,
                delta=self.delta,
                enable_selective=self.enable_selective,
                enable_repartition=self.enable_repartition,
                ntp=self.ntp,
                ntp_min_credit=(self.credit.ntp_band if self.credit else 0.0),
                node_of=self.node_of,
                domain_of=self.domain_of,
                # effective speeds are normalized against the healthy plan's
                # widest group even when re-adapting a shrunk plan
                baseline_tp=max(st.tp for rep in self.plan0.replicas
                                for st in rep.stages),
                # with a fixed or modeled planning charge the measured wall
                # clock is never read — keep the hot loop syscall-free so
                # plan-cache hits are truly free
                measure_overhead=(self.plan_overhead_fixed is None
                                  and self.plan_overhead_model is None),
            )

    def decide(self, speeds, *, changed: bool,
               excluded=frozenset(), risk=None,
               credit=None) -> PolicyDecision:
        failed = {d for d, v in speeds.items() if v <= 0.0}
        # quarantine exclusion is owned by Scheduler.adapt (it unions
        # quarantined into failed and records the note); risk flows through
        # to the placement tie-breaks (risk-aware planning, hazard switch)
        # and credit supersedes it (unified-credit switch)
        ad = self.scheduler.adapt(self.plan0, speeds, failed=failed,
                                  quarantined=frozenset(excluded),
                                  device_risk=risk, device_credit=credit)
        overhead = 0.0
        if changed:
            # layer-transfer volume: layers each stage must *fetch* relative
            # to the plan currently executing — not plan0, which overcharged
            # every reconfiguration after the first (consecutive exclusion
            # plans re-paid transfers for layers already in place)
            moved_layers = 0
            for s, (old, new) in enumerate(
                zip(self._prev_plan.replicas[0].stages,
                    ad.plan.replicas[0].stages)
            ):
                moved_layers += len(set(new.layers) - set(old.layers))
            if self.plan_overhead_fixed is not None:
                plan_s = self.plan_overhead_fixed
            elif self.plan_overhead_model is not None:
                plan_s = self.plan_overhead_model.predict(
                    len(self.plan0.devices), len(self.layer_costs))
            else:
                plan_s = ad.plan_overhead_s
            overhead = (
                plan_s
                + self.group_rebuild_s
                + moved_layers * self.layer_transfer_s_per_layer
            )
        notes = list(ad.notes)
        if changed and self.domains is not None \
                and getattr(self.domains, "restart", None) is not None:
            # checkpoint/restart economics: when the modeled cost of
            # restart-from-checkpoint (relaunch + restore read + replayed
            # work) undercuts live adaptation (replan + group rebuild +
            # layer migration), take the restart — state reaches the new
            # plan via the checkpoint restore instead of layer transfers,
            # and the session is charged the restart price. Strictly-below
            # comparison: at equal cost live adaptation wins (no lost
            # iterations to replay outside the model's expectation).
            restart_s = self.domains.restart.restart_cost_s()
            threshold = overhead
            if credit and self.credit is not None \
                    and getattr(self.credit, "restart_weighting", False):
                # aggregate group credit weighs the restart-vs-adapt call: a
                # low-credit plan is likely interrupted again before the
                # restored session repays the restore, so the live-adaptation
                # threshold is discounted by the plan's mean credit
                vals = [credit.get(d, 1.0) for d in ad.plan.devices]
                if vals:
                    threshold = overhead * (sum(vals) / len(vals))
            if restart_s < threshold:
                notes.insert(0, "restart-from-checkpoint: "
                                f"{restart_s:.3f}s < live {threshold:.3f}s")
                overhead = restart_s
        self._prev_plan = ad.plan
        return PolicyDecision(
            plan=ad.plan,
            stage_speeds=ad.stage_speeds,
            migration_policy=self.migration_mode,
            n_mb=[self.plan0.microbatches] * self.plan0.dp,
            reconfig_overhead_s=overhead,
            aborted=ad.restore_required,  # needs checkpoint fallback (Fig. 8b)
            delta=self.delta,
            detail="; ".join(notes[:3]),
        )


def make_policy(name: str, plan0: ParallelPlan, layer_costs, **kw) -> BasePolicy:
    name = name.lower()
    if name == "resihp":
        return ResiHPPolicy(plan0, layer_costs, **kw)
    if name == "recycle":
        return ReCyclePolicy(plan0, layer_costs, **kw)
    if name in ("recycle+", "recycle-strong"):
        return ReCyclePolicy(plan0, layer_costs, failslow_aware=True, **kw)
    if name == "oobleck":
        return OobleckPolicy(plan0, layer_costs, **kw)
    if name in ("oobleck+", "oobleck-strong"):
        return OobleckPolicy(plan0, layer_costs, failslow_aware=True, **kw)
    if name == "greyhound":
        return GreyhoundPolicy(plan0, layer_costs, **kw)
    if name == "adaptra":
        return AdaptraPolicy(plan0, layer_costs, **kw)
    raise ValueError(name)
