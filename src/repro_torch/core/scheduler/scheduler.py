"""The ResiHP Scheduler (paper §6): progressive TP -> PP -> DP adaptation.

Given a failure report (from the Detector), the current ParallelPlan, and
per-device normalized throughputs, produce an AdaptationPlan:

  1. TP (§6.1): selective exclusion inside each affected TP group (Eq. 3/4);
     survivors that don't fit the power-of-two subgroup become node-local
     standbys; a group with no feasible subgroup leaves a *dead stage*.
  2. PP (§6.2): uniform layer repartition against per-stage effective speeds.
     Uniform across DP replicas (gradient all-reduce stays layer-aligned), so
     the per-stage speed used is the min across replicas — the global DP
     sync is gated by the slowest replica at that stage.
  3. DP (§6.3): stage-granular progress-aware migration parameters (delta,
     memory capacity) for the online migrator; dead stages are marked for
     fail-stop eviction.

The Scheduler is pure planning — no jax. The engine/cluster-sim executes
plans; `plan_overhead_s` is measured for the Fig. 13 overhead benchmark.

A copy of `repro.core.scheduler.scheduler`, kept whole here, since the
port's driver adapts its plans with it, without importing the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.scheduler.plan import ParallelPlan, ReplicaPlan, StagePlan
from repro_torch.core.scheduler.repartition import repartition_layers
from repro_torch.core.scheduler.tp_reconfig import (NTPConfig, TPReconfig,
                                              reconfigure_tp_group)


@dataclass
class AdaptationPlan:
    plan: ParallelPlan
    stage_speeds: dict  # (replica, stage) -> effective speed (healthy tp = 1.0)
    dead_stages: tuple  # ((replica, stage), ...)
    restore_required: bool  # all replicas of some stage are dead (Fig. 8b)
    plan_overhead_s: float
    notes: list = field(default_factory=list)


@dataclass(frozen=True)
class PlanOverheadModel:
    """Modeled planning-cost curve: a power law ``t = exp(intercept) * x**coef``
    in the problem size ``x = n_devices * n_layers``, fit (log-log least
    squares) to the measured ``Scheduler.adapt`` wall times of the Fig. 13
    overhead benchmark.

    Replaces the *measured* wall-clock planning charge
    (``AdaptationPlan.plan_overhead_s``, honest but nondeterministic and
    machine-dependent) with a deterministic prediction at the same scale —
    closing the ROADMAP item without falling back to a blunt constant the
    way ``plan_overhead_fixed`` does. ``bench_fig13_overhead`` refits the
    curve against fresh measurements every run and reports the fit error, so
    drift between the checked-in default and reality is visible nightly.
    """

    coef: float = 1.4165360  # power-law exponent over n_devices * n_layers
    intercept: float = -17.3245871  # log-seconds at x = 1
    fit_mape: float = 0.0227  # of the default fit (results/fig13_overhead.json)

    def predict(self, n_devices: int, n_layers: int) -> float:
        return self.predict_x(float(n_devices) * float(n_layers))

    @classmethod
    def fit(cls, samples) -> "PlanOverheadModel":
        """``samples``: iterable of (n_devices, n_layers, measured_seconds).
        Closed-form least squares on (log x, log t)."""
        pts = [(math.log(max(float(d) * float(layers), 1.0)), math.log(t))
               for d, layers, t in samples if t > 0]
        if len(pts) < 2:
            raise ValueError("PlanOverheadModel.fit needs >= 2 samples")
        n = len(pts)
        mx = sum(x for x, _ in pts) / n
        my = sum(y for _, y in pts) / n
        sxx = sum((x - mx) ** 2 for x, _ in pts)
        sxy = sum((x - mx) * (y - my) for x, y in pts)
        coef = sxy / max(sxx, 1e-18)
        intercept = my - coef * mx
        model = cls(coef=coef, intercept=intercept)
        mape = sum(abs(model.predict_x(math.exp(x)) - math.exp(y))
                   / math.exp(y) for x, y in pts) / n
        return dataclasses.replace(model, fit_mape=mape)

    def predict_x(self, x: float) -> float:
        return math.exp(self.intercept) * max(x, 1.0) ** self.coef


def k_min_for(param_bytes_per_layer: float, n_layers_stage: int,
              hbm_bytes: float, *, state_multiplier: float = 4.0,
              activation_bytes: float = 2e9) -> int:
    """Memory floor for the TP degree of one stage: params+optimizer shards
    plus activation working set must fit per device."""
    need = param_bytes_per_layer * n_layers_stage * state_multiplier
    avail = max(hbm_bytes - activation_bytes, 1.0)
    k = 1
    while need / k > avail:
        k *= 2
    return k


@dataclass
class Scheduler:
    layer_costs: list  # per-layer healthy cost (repartition input)
    k_min: int = 1
    delta: int = 0
    mem_capacity: Optional[int] = None
    min_layers: int = 1
    repartition_rel_threshold: float = 0.05  # skip repartition for tiny gains
    # ablation switches (Fig. 11): progressive adaptation components
    enable_selective: bool = True  # §6.1 selective exclusion (else whole-group)
    enable_repartition: bool = True  # §6.2 layer repartition
    # False => skip the wall-clock measurement entirely (plan_overhead_s is
    # reported as 0.0). Set by ResiHPPolicy when a plan_overhead_model /
    # plan_overhead_fixed makes the measurement dead weight — the modeled hot
    # loop stays syscall-free and plan-cache hits are truly free.
    measure_overhead: bool = True
    # plan cache: ``adapt`` is a pure function of (plan, speeds, failed,
    # quarantined, risk, ntp mode), so repeated reconfigurations under flapping /
    # poisson storms that revisit a failure signature skip the O(S·n²)
    # repartition DP + TP search. 0 disables. Cached AdaptationPlans are
    # shared — treat them as read-only (every in-repo consumer does).
    plan_cache_size: int = 256
    # healthy-baseline TP degree used to normalize per-stage effective
    # speeds. None => derived from the incoming plan's widest group — correct
    # only while that plan still contains a healthy-width group, which is why
    # ResiHPPolicy pins it from plan0 (adapting an already-shrunk plan must
    # not inflate the surviving stages' speeds).
    baseline_tp: Optional[int] = None
    # physical topology view for the §6.1 node-local-standby contract: a
    # callable (device -> node) or an indexable per-device node array
    # (ClusterState.node_of). None => plan-only callers keep the whole-pool
    # legacy behaviour (no topology to filter by).
    node_of: Optional[object] = None
    # correlated-failure-domain view (device -> domain index; a callable or
    # an indexable array, wired from ClusterTopology.pdu_of & co. by the
    # domain-aware policy switch): among the node-local standbys a group may
    # pull in, offers are stably ordered toward domains with *fewer* failed
    # devices, so backfill straddles domains instead of refilling from the
    # rack that is busy dying. None (the default) keeps the legacy offer
    # order — byte-identical planning.
    domain_of: Optional[object] = None
    # nonuniform-TP adaptation axis (NTPConfig; ``True`` for defaults;
    # default OFF = exclusion-only Eq. 3/4, byte-identical legacy planning)
    ntp: Optional[object] = None
    # credit-gated NTP (credit switch only): devices whose credit sits
    # strictly below this band are vetoed from shrink-shard retention —
    # nonuniform widths are for trustworthy stragglers, a low-credit slow
    # device competes as an exclusion instead. 0.0 (the default) disables
    # the veto, so callers without a credit view are untouched.
    ntp_min_credit: float = 0.0
    # counter sink for the credit path (a CreditStats-shaped object): the
    # planner is the only layer that knows when the NTP veto actually bites,
    # so it bumps ``ntp_vetoes`` here on every uncached plan that vetoed
    # someone. None (the default) counts nothing.
    credit_stats: Optional[object] = field(default=None, repr=False,
                                           compare=False)
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        if self.ntp is True:
            self.ntp = NTPConfig()

    def _signature(self, speeds: dict, failed, quarantined, device_risk,
                   device_credit=None):
        """Frozen (failed, quarantined, risk-bucketed speeds) cache key.
        Healthy (1.0) speeds are elided so the signature scales with the
        failure count, not the fleet; risk/credit scores are bucketed at
        1e-6 — fine enough that a tie-break could only flip between devices
        whose estimated hazards are practically indistinguishable. The NTP
        config is part of the key: the same failure set yields a different
        plan under shrink-shard than under exclusion, and a cached exclusion
        plan must not alias an NTP request (or vice versa)."""
        sig_speeds = tuple(sorted(
            (d, v) for d, v in speeds.items() if v != 1.0))
        sig_risk = (tuple(sorted((d, round(r, 6))
                                 for d, r in device_risk.items()))
                    if device_risk else None)
        sig_credit = (tuple(sorted((d, round(c, 6))
                                   for d, c in device_credit.items()))
                      if device_credit else None)
        return (sig_speeds, frozenset(failed), frozenset(quarantined),
                sig_risk, sig_credit, self.ntp)

    # ------------------------------------------------------------ adaptation
    def adapt(self, plan: ParallelPlan, speeds: dict, *,
              failed=frozenset(), quarantined=frozenset(),
              device_risk=None, device_credit=None) -> AdaptationPlan:
        """speeds: {device_id: p_i}; failed: fail-stop device ids (speed 0);
        quarantined: lifecycle-quarantined devices — excluded from plans (and
        the standby pool) exactly like failed ones, even if a rejoin has made
        them physically alive, so the Scheduler stops replanning around
        flappers until their quarantine expires.
        device_risk: optional {device_id: hazard score} from the lifecycle
        hazard estimator — equal-throughput placement choices (TP membership,
        standby pull-in) prefer low-hazard devices; None (the default) keeps
        selection byte-identical to the hazard-blind planner.
        device_credit: optional {device_id: credit in [0, 1]} from the
        unified credit model — supersedes ``device_risk`` (low credit maps
        to high risk for the same tie-breaks) and, with ``ntp_min_credit``
        set, vetoes low-credit devices from shrink-shard retention."""
        key = entry = None
        if self.plan_cache_size > 0:
            key = self._signature(speeds, failed, quarantined, device_risk,
                                  device_credit)
            entry = self._cache.get(key)
            # the entry pins its plan object, so an `is` match cannot be an
            # id-reuse collision; a different plan under the same signature
            # (rare: only multi-plan callers) simply recomputes
            if entry is not None and entry[0] is plan:
                return entry[1]
        ad = self._adapt_uncached(plan, speeds, failed=failed,
                                  quarantined=quarantined,
                                  device_risk=device_risk,
                                  device_credit=device_credit)
        if key is not None:
            if len(self._cache) >= self.plan_cache_size:
                self._cache.clear()
            self._cache[key] = (plan, ad)
        return ad

    def _adapt_uncached(self, plan: ParallelPlan, speeds: dict, *,
                        failed=frozenset(), quarantined=frozenset(),
                        device_risk=None, device_credit=None) -> AdaptationPlan:
        t0 = time.perf_counter() if self.measure_overhead else 0.0
        ntp_veto = frozenset()
        if device_credit:
            # credit supersedes the raw hazard view: the same placement
            # tie-breaks run on ``2 - credit`` (injective, order-reversing
            # in credit), so low-credit devices rank exactly like
            # high-hazard ones without a second ranking path
            device_risk = {d: 2.0 - c for d, c in device_credit.items()}
            if self.ntp is not None and self.ntp_min_credit > 0.0:
                ntp_veto = frozenset(d for d, c in device_credit.items()
                                     if c < self.ntp_min_credit)
                if ntp_veto and self.credit_stats is not None:
                    self.credit_stats.ntp_vetoes += len(ntp_veto)
        failed = (set(failed) | {d for d, v in speeds.items() if v <= 0.0}
                  | set(quarantined))
        # per-domain failed-device counts for domain-spread standby offers
        # (None when no domain view is wired: legacy offer order)
        dom_fail = None
        if self.domain_of is not None and failed:
            dom_fail = {}
            for d in failed:
                dom = self._domain(d)
                dom_fail[dom] = dom_fail.get(dom, 0) + 1
        notes = []
        if quarantined:
            notes.append(f"quarantined (excluded): {sorted(quarantined)}")
        if device_credit:
            worst = min(device_credit.items(), key=lambda kv: (kv[1], kv[0]))
            notes.append(f"credit-aware placement over {len(device_credit)} "
                         f"scored devices (worst d{worst[0]}: {worst[1]:.2f})")
        elif device_risk:
            worst = max(device_risk.items(), key=lambda kv: (kv[1], kv[0]))
            notes.append(f"risk-aware placement over {len(device_risk)} "
                         f"scored devices (worst d{worst[0]}: {worst[1]:.2f}x)")

        # ---- 1. TP: reconfigure every affected group --------------------
        new_replicas = []
        group_speed: dict = {}
        dead: list = []
        standby_pool = [d for d in plan.standby if d not in failed]
        for r, rep in enumerate(plan.replicas):
            stages = []
            for s, st in enumerate(rep.stages):
                # a stage already running nonuniform widths is always
                # re-planned: if its straggler recovered, the widths should
                # revert to uniform (exclusion wins ties at full health)
                affected = st.shard_fractions is not None or any(
                    d in failed or speeds.get(d, 1.0) < 1.0 for d in st.devices)
                if not affected:
                    stages.append(st)
                    group_speed[(r, s)] = 1.0 * st.tp
                    continue
                if not self.enable_selective and any(d in failed for d in st.devices):
                    # ablation: conservative whole-group exclusion (§3.2)
                    dead.append((r, s))
                    stages.append(StagePlan((), st.layers))
                    group_speed[(r, s)] = 0.0
                    notes.append(f"stage (dp{r},pp{s}) dead: whole-group exclusion")
                    continue
                # pull node-local standbys into the candidate pool (§6.1 —
                # only standbys co-located with the group's node(s) qualify)
                offered = self._local_standbys(st.devices, standby_pool,
                                               dom_fail)
                pool = list(st.devices) + offered
                rec: TPReconfig = reconfigure_tp_group(
                    pool, speeds, k_min=self.k_min, failed=failed,
                    risk=device_risk, ntp=self.ntp, ntp_veto=ntp_veto)
                if rec.tp == 0:
                    dead.append((r, s))
                    stages.append(StagePlan((), st.layers))
                    group_speed[(r, s)] = 0.0
                    notes.append(f"stage (dp{r},pp{s}) dead: no feasible TP subgroup")
                    continue
                # consumed standbys leave the pool; freed devices join it;
                # standbys never offered (other nodes) keep their place
                standby_pool = (
                    [d for d in standby_pool if d not in pool]
                    + [d for d in rec.standby if d not in st.devices]
                    + [d for d in rec.standby if d in st.devices]
                )
                standby_pool = list(dict.fromkeys(standby_pool))
                stages.append(StagePlan(rec.devices, st.layers,
                                        rec.shard_fractions))
                group_speed[(r, s)] = rec.effective_throughput
                if rec.mode == "shrink":
                    widths = "/".join(f"{f:.2f}" for f in rec.shard_fractions)
                    notes.append(
                        f"stage (dp{r},pp{s}) NTP shrink-shard tp={rec.tp} "
                        f"widths=[{widths}] thru={rec.effective_throughput:.2f}"
                    )
                elif rec.tp != st.tp:
                    notes.append(
                        f"stage (dp{r},pp{s}) TP {st.tp}->{rec.tp} "
                        f"thru={rec.effective_throughput:.2f}"
                    )
            new_replicas.append(ReplicaPlan(tuple(stages)))

        # ---- 2. PP: uniform layer repartition ---------------------------
        pp = plan.replicas[0].pp
        # normalize against the *healthy* baseline TP, not the incoming
        # plan's current widths: when adapting an already-shrunk plan the
        # incoming max degree understates healthy capacity and would inflate
        # every surviving stage's effective speed. The fallback scans all
        # replicas for the widest (least-degraded) group.
        tp0 = self.baseline_tp or max(
            st.tp for rep in plan.replicas for st in rep.stages) or 1
        # per-stage effective speed normalized to the healthy group = min
        # across live replicas (the DP sync is gated by the slowest replica)
        stage_speed = []
        for s in range(pp):
            vals = [
                group_speed[(r, s)] / tp0
                for r in range(plan.dp)
                if (r, s) not in dead
            ]
            stage_speed.append(min(vals) if vals else 0.0)

        restore_required = any(v == 0.0 for v in stage_speed)
        if not restore_required and self.enable_repartition:
            old_layers = [st.layers for st in new_replicas[0].stages]
            new_parts = repartition_layers(
                self.layer_costs, stage_speed, min_layers=self.min_layers)
            if self._worth_it(old_layers, new_parts, stage_speed, notes):
                new_replicas = [
                    ReplicaPlan(tuple(
                        StagePlan(st.devices, new_parts[s], st.shard_fractions)
                        for s, st in enumerate(rep.stages)
                    ))
                    for rep in new_replicas
                ]

        new_plan = plan.replace(
            replicas=tuple(new_replicas),
            standby=tuple(sorted(standby_pool)),
            dead_stages=tuple(dead),
        )
        # effective per-(replica,stage) speed for the migrator / simulator
        eff = {
            (r, s): group_speed[(r, s)] / tp0
            for r in range(plan.dp)
            for s in range(pp)
        }
        return AdaptationPlan(
            plan=new_plan,
            stage_speeds=eff,
            dead_stages=tuple(dead),
            restore_required=restore_required,
            plan_overhead_s=(time.perf_counter() - t0
                             if self.measure_overhead else 0.0),
            notes=notes,
        )

    def _node(self, device) -> int:
        nf = self.node_of
        return int(nf(device)) if callable(nf) else int(nf[device])

    def _domain(self, device) -> int:
        df = self.domain_of
        return int(df(device)) if callable(df) else int(df[device])

    def _local_standbys(self, group, standby_pool, dom_fail=None) -> list:
        """§6.1 node-local standby contract: a group may only pull in
        standbys co-located with its node(s). Without a topology view
        (node_of=None, plan-only callers) the whole pool qualifies.
        ``dom_fail`` (per-domain failed counts, domain-aware switch only)
        stably reorders the qualifying offers toward less-failed domains —
        ties, and the no-domain-view path, keep the legacy pool order."""
        if self.node_of is None or not standby_pool:
            offers = list(standby_pool)
        else:
            nodes = {self._node(d) for d in group}
            offers = [d for d in standby_pool if self._node(d) in nodes]
        if dom_fail:
            offers.sort(key=lambda d: dom_fail.get(self._domain(d), 0))
        return offers

    def _worth_it(self, old_parts, new_parts, stage_speed, notes) -> bool:
        from repro_torch.core.scheduler.repartition import partition_bottleneck

        old_b = partition_bottleneck(self.layer_costs, old_parts, stage_speed)
        new_b = partition_bottleneck(self.layer_costs, new_parts, stage_speed)
        if new_b <= old_b * (1.0 - self.repartition_rel_threshold):
            notes.append(f"repartition: bottleneck {old_b:.3f} -> {new_b:.3f}")
            return True
        notes.append(
            f"repartition skipped (gain {1 - new_b / max(old_b, 1e-12):.1%} "
            f"< {self.repartition_rel_threshold:.0%})"
        )
        return False

    # ---------------------------------------------------------- migration
    def migrator_kwargs(self, adaptation: AdaptationPlan, *, n_mb, chunk_base_cost,
                        schedule="1f1b", p2p_cost=0.0, migrate_edge_cost=0.0):
        """Bundle Algorithm-1 parameters for ProgressAwareMigrator. The chunk
        cost divides the healthy cost by the executor's effective speed."""
        speeds = adaptation.stage_speeds
        layer_share = {}
        total = sum(self.layer_costs)
        for s, layers in enumerate(adaptation.plan.replicas[0].stages):
            layer_share[s] = sum(self.layer_costs[i] for i in layers.layers) / total

        def chunk_cost(cid, executor):
            base = chunk_base_cost(cid) * layer_share[cid.stage] * len(self.layer_costs)
            v = speeds.get(executor, 1.0)
            return base / max(v, 1e-9)

        plan = adaptation.plan
        return dict(
            n_stages=plan.replicas[0].pp,
            n_replicas=plan.dp,
            n_microbatches=plan.microbatches,
            chunk_cost=chunk_cost,
            schedule=schedule,
            dead_executors=adaptation.dead_stages,
            policy="resihp",
            delta=self.delta,
            mem_capacity=self.mem_capacity,
            p2p_cost=p2p_cost,
            migrate_edge_cost=migrate_edge_cost,
        )
