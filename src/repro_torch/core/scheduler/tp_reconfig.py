"""Selective device exclusion within affected TP groups (paper §6.1).

Given the original TP group G, the fail-stop set F_stop, and per-device
normalized throughput p_i (1.0 = healthy peak), the Scheduler:

  1. generates candidate TP degrees  K = {k | k_min <= k <= |G'|, k = 2^q}
     (Eq. 3) where G' = G \\ F_stop and k_min is the memory floor;
  2. for each k, greedily picks the top-k devices by p_i (healthy first,
     fastest fail-slow devices only when needed);
  3. selects S* = argmax_k ( k * min_{i in S_k} p_i )  (Eq. 4) — TP collectives
     synchronize every layer, so a group runs at its slowest member's rate,
     while a larger k scales aggregate compute;
  4. keeps unassigned healthy devices online as node-local standbys.

Risk-aware placement (PR 4, default off): when a per-device hazard view is
supplied (``risk={device: estimated rate / fleet prior}``, from the failure-
lifecycle hazard estimator), equal-throughput choices break toward the
lower-hazard device — Eq. 4 still decides throughput, but among the many
speed-1.0 candidates the greedy ranking stops being arbitrary and prefers
devices that are least likely to force the *next* reconfiguration. With
``risk=None`` the selection is byte-identical to the pre-hazard behaviour.

Nonuniform TP (NTP, default off): when an :class:`NTPConfig` is supplied, a
*shrink-shard* candidate competes with Eq. 4 exclusion — keep the degraded
device but give it a shard proportional to its measured speed (widths
``f_i ∝ p_i``). The group's per-layer time is ``max_i(f_i / p_i)`` (every
rank still synchronizes per layer, but a slow rank now has less work), so
proportional widths make the effective throughput ``efficiency * sum(p_i)``
instead of ``k * min(p_i)`` — the mildly-slow device contributes its actual
speed rather than dragging the whole group down or being thrown away. The
efficiency discount models ragged-collective overhead; it is what keeps a
healthy uniform group from "shrinking" to no benefit (ties and losses keep
the exclusion plan, so ``ntp=None`` callers see byte-identical output).

A copy of `repro.core.scheduler.tp_reconfig`, kept whole here, since the
Scheduler's TP step uses it, without importing the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.scheduler.plan import NTP_EFFICIENCY


@dataclass(frozen=True)
class NTPConfig:
    """Nonuniform-TP planning knobs (arxiv 2504.06095).

    efficiency: planner's estimate of the nonuniform-collective efficiency
        (defaults to the simulator's ground-truth system constant).
    min_fraction: smallest useful shard width — a device whose proportional
        width would land below this is left on standby instead (a 2% sliver
        of the weights is not worth a rank in every collective).
    """

    efficiency: float = NTP_EFFICIENCY
    min_fraction: float = 0.04


@dataclass(frozen=True)
class TPReconfig:
    devices: tuple  # selected subgroup S*, sorted by device id
    tp: int
    effective_throughput: float  # k * min p_i  (in units of one healthy device)
    standby: tuple  # surviving devices left out of S*
    excluded: tuple  # fail-stop devices removed
    # NTP shrink-shard result: per-device widths aligned with ``devices``
    # (None = uniform shards, the classic exclusion outcome)
    shard_fractions: Optional[tuple] = None
    mode: str = "exclude"  # 'exclude' (Eq. 4) | 'shrink' (NTP widths)

    @property
    def group_speed(self) -> float:
        """Throughput per member — ``min p_i`` for uniform shards (the rate
        every member effectively runs at), the mean contribution for NTP."""
        return self.effective_throughput / max(self.tp, 1)


def candidate_degrees(n_survivors: int, k_min: int) -> list:
    """Eq. 3: power-of-two degrees in [k_min, |G'|]."""
    ks, k = [], 1
    while k <= n_survivors:
        if k >= k_min:
            ks.append(k)
        k *= 2
    return ks


def shrink_shard_candidate(survivors, speeds, ntp: NTPConfig,
                           *, k_min: int = 1,
                           veto=frozenset()) -> Optional[TPReconfig]:
    """NTP candidate over the surviving pool: widths ``f_i ∝ p_i`` so the
    group's per-layer time ``max_i(f_i / p_i)`` is flat across members and
    throughput reaches ``efficiency * sum(p_i)``.

    Two constraints shape the widths:

    * devices whose proportional width falls below ``ntp.min_fraction`` are
      dropped to standby (iteratively, slowest first — dropping one raises
      everyone else's share);
    * the memory floor caps any width at ``1/k_min`` (the same HBM bound
      Eq. 3 expresses as a minimum degree); capped excess re-spreads
      proportionally over the uncapped members (water-filling).

    ``veto`` (credit-gated NTP, default empty = legacy behaviour): devices a
    caller's trust model bars from shrink-shard retention — they go to
    standby like a below-min-fraction sliver, so the exclusion candidate is
    the only plan that may keep them. Nonuniform widths are for trustworthy
    stragglers (thermal capping); a device whose *history* says the slowness
    is a symptom should compete as an exclusion, not keep a shard.

    Returns None when no feasible group remains (fewer than ``k_min``
    members, or fewer than 2 — a single-device "group" is plain exclusion).
    """
    kept = sorted((d for d in survivors if d not in veto),
                  key=lambda d: (-speeds.get(d, 1.0), d))
    while kept:
        tot = sum(speeds.get(d, 1.0) for d in kept)
        if speeds.get(kept[-1], 1.0) / tot >= ntp.min_fraction:
            break
        kept.pop()
    if len(kept) < max(k_min, 2):
        return None
    cap = 1.0 / k_min
    p = {d: speeds.get(d, 1.0) for d in kept}
    free = {d: v / sum(p.values()) for d, v in p.items()}
    capped: dict = {}
    while True:
        over = [d for d in free if free[d] > cap + 1e-12]
        if not over:
            break
        for d in over:
            capped[d] = cap
            del free[d]
        rem = 1.0 - cap * len(capped)
        if not free or rem <= 1e-12:
            return None  # memory floor leaves no width to distribute
        tot = sum(p[d] for d in free)
        free = {d: rem * p[d] / tot for d in free}
    widths = {**capped, **free}
    worst = max(widths[d] / p[d] for d in kept)
    thru = ntp.efficiency / worst
    devices = tuple(sorted(kept))
    return TPReconfig(
        devices, len(devices), thru,
        standby=tuple(sorted(set(survivors) - set(kept))),
        excluded=(),
        shard_fractions=tuple(widths[d] for d in devices),
        mode="shrink",
    )


def reconfigure_tp_group(group, speeds, *, k_min: int = 1,
                         failed=(), risk=None,
                         ntp: Optional[NTPConfig] = None,
                         ntp_veto=frozenset()) -> TPReconfig:
    """group: device ids of the original TP group.
    speeds: {device_id: normalized throughput p_i}; fail-stop devices may be
    listed in `failed` or have speed <= 0.
    k_min: memory floor — the minimum TP degree whose shards still fit HBM.
    risk: optional {device_id: hazard score} — equal-speed ties rank
    low-hazard first (None => exact legacy ordering).
    ntp: optional NTPConfig — also score a shrink-shard (nonuniform-width)
    candidate and return it when it strictly beats exclusion (None => exact
    legacy exclusion-only behaviour).
    ntp_veto: devices barred from shrink-shard retention (credit-gated NTP;
    empty => every survivor is shrink-eligible, the legacy behaviour).
    """
    # a device absent from `speeds` is healthy (p = 1.0) everywhere in this
    # module — only an explicit `failed` listing or a speed <= 0 excludes it
    failed = set(failed) | {d for d in group if speeds.get(d, 1.0) <= 0.0}
    survivors = [d for d in group if d not in failed]
    ks = candidate_degrees(len(survivors), k_min)
    if not ks:
        return TPReconfig((), 0, 0.0, tuple(sorted(survivors)), tuple(sorted(failed)))

    # rank by normalized throughput, healthy (1.0) first; with a hazard view,
    # equal-speed ties prefer the lower-risk device (risk-aware placement)
    if risk is None:
        ranked = sorted(survivors, key=lambda d: -speeds.get(d, 1.0))
    else:
        ranked = sorted(survivors,
                        key=lambda d: (-speeds.get(d, 1.0),
                                       risk.get(d, 1.0)))
    best, best_thru = None, -1.0
    for k in ks:
        sk = ranked[:k]
        thru = k * min(speeds.get(d, 1.0) for d in sk)
        # strictly-greater keeps the smallest k on ties -> frees more standbys
        if thru > best_thru:
            best, best_thru = sk, thru
    standby = tuple(sorted(set(survivors) - set(best)))
    exclude = TPReconfig(tuple(sorted(best)), len(best), best_thru, standby,
                         tuple(sorted(failed)))
    if ntp is None:
        return exclude
    shrink = shrink_shard_candidate(survivors, speeds, ntp, k_min=k_min,
                                    veto=ntp_veto)
    # strictly-greater: ties keep exclusion (uniform shards, frees standbys)
    if shrink is None or shrink.effective_throughput <= best_thru:
        return exclude
    return dataclasses.replace(shrink, excluded=tuple(sorted(failed)))


def backfill_from_standby(reconf: TPReconfig, speeds, *, k_min: int = 1,
                          risk=None, ntp: Optional[NTPConfig] = None) -> TPReconfig:
    """Re-run selection over survivors + standbys (used when a later failure
    hits the group again and the node-local standby pool can help — §6.1
    'reuse them for subsequent intra-node failures')."""
    pool = list(reconf.devices) + list(reconf.standby)
    return reconfigure_tp_group(pool, speeds, k_min=k_min, risk=risk, ntp=ntp)
