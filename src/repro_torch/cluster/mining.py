"""Coverage-guided adversarial scenario mining over the failure-scenario DSL.

The 18-scenario catalog is hand-authored: sweeps over it only measure
failure patterns somebody already thought of. This module searches the
scenario space itself — seeded, budget-bounded, on the fast engine at the
Fig. 14 scale (256 devices) — for *distinct* worst-case failure timelines:

* **candidates** are literal event timelines — tuples of
  ``(t, kind, target, value)`` — produced by mutating and splicing the
  compiled catalog (perturb times/severities, retarget victims, duplicate
  and drop events, splice event subsequences between scenarios, compose
  whole families);
* every candidate is canonicalized by :func:`repair_timeline`, which turns
  an arbitrary event soup into a timeline that passes
  :meth:`EventTrace.validate <repro_torch.cluster.events.EventTrace.validate>` —
  the same hardening that rejects contradictory hand-written scenarios —
  and bounds the adversary's *failure budget* to the worst hand-authored
  storm's (so the miner finds scheduling/timing attacks, not trivial
  mass kills);
* candidates are **scored** by per-policy session-throughput loss under
  ``resihp`` plus a bonus for *policy-ranking flips* — cases where a
  baseline that ``resihp`` normally beats comes out ahead;
* the archive is keyed by a coarse **timeline feature signature**
  (:func:`signature`): near-identical candidates collapse into one cluster
  and the search keeps the best scorer per cluster while mutating from the
  elite set (MAP-elites style), so the output ranks *distinct* failure
  patterns rather than one pattern rediscovered a hundred times.

Because every candidate is an engine input nobody hand-checked, the mining
loop doubles as a continuous fuzz harness for the scenario/event/engine
stack: ``tests/test_mining.py`` replays mutated candidates through both
execution engines and pins fast/python parity on each.

Determinism contract: :func:`mine` is a pure function of
``(seed, budget, config)`` — mutation RNG streams are derived per
``(seed, generation, slot)``, candidate evaluation is a pure function of
the candidate, and archive updates happen in canonical slot order — so the
mined JSON is byte-identical across runs *and across worker counts* when
the evaluation fans out through ``benchmarks.sweep.pmap``.

The driver is ``tools/mine_scenarios.py``; the checked-in survivors are the
``adversarial_*`` family in :mod:`repro_torch.cluster.scenarios`, regression-
pinned by ``tests/test_adversarial_golden.py``.

A copy of `repro.cluster.mining`, kept whole here, without importing the
JAX package; the driver and the golden named above run the reference.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.cluster.events import DEVICE_KINDS, NODE_KINDS, EventTrace
from repro_torch.cluster.registry import ClusterTopology
from repro_torch.cluster.simulator import SimConfig, TrainingSim

__all__ = [
    "MINING_MODEL", "POLICIES", "mining_config", "mining_topology",
    "catalog_seeds", "compile_seed_timelines", "damage", "damage_cap",
    "repair_timeline", "mutate", "signature", "evaluate_candidate",
    "score", "mine", "to_json",
]

# ------------------------------------------------------------- mining scale
# llama2-13b layer costs on the paper's Table-3 "xlarge" parallelism —
# (TP, DP, PP) = (4, 4, 16) = 256 devices, the Fig. 14 scale. Small enough
# that the fast engine scores thousands of candidates per CPU-hour, large
# enough that rack locality and TP-group structure matter.
MINING_MODEL = dict(dp=4, pp=16, tp=4, n_layers=40, n_microbatches=8,
                    seq_len=8192, noise=0.01)

# policy label -> (policy name, policy kwargs). The resihp row charges the
# deterministic PlanOverheadModel so a candidate's score is a pure function
# of its timeline (the same contract benchmarks/sweep.py cells rely on).
POLICIES = {
    "resihp": ("resihp", {"plan_overhead_model": True}),
    "recycle+": ("recycle+", {}),
    "oobleck+": ("oobleck+", {}),
}

FAIL_KINDS = ("fail-stop", "fail-stop-node", "fail-slow", "net-degrade")


def mining_config(seed: int = 0, **overrides) -> SimConfig:
    kw = dict(MINING_MODEL)
    kw.update(overrides)
    return SimConfig(seed=seed, **kw)


def mining_topology(cfg: SimConfig) -> ClusterTopology:
    return ClusterTopology(math.ceil(cfg.n_devices / cfg.devices_per_node),
                           cfg.devices_per_node)


# ------------------------------------------------------------ seed catalog
def catalog_seeds(span: float) -> dict:
    """The hand-authored catalog rescaled to the mining span — the initial
    population and the donor pool for splice/compose operators.

    ``table5_failslow`` (a single event) and ``example_mixed`` (an example
    with literal quickstart device ids) are omitted; the ``adversarial_*``
    family itself is never a seed, so re-mining cannot bootstrap from its
    own previous output."""
    from repro_torch.cluster.scenarios import get
    return {
        "fig9_failslow": get("fig9_failslow", at=0.12 * span),
        "fig10_mixed": get("fig10_mixed", span=span),
        "fig11_mixed": get("fig11_mixed", span=span),
        "fig14_largescale": get("fig14_largescale", span=span),
        "table6_failstop": get("table6_failstop", span=span),
        "rack_storm": get("rack_storm", at=0.15 * span,
                          recover_after=0.5 * span),
        "rack_storm_256": get("rack_storm_256", span=span),
        "flap_then_recover": get("flap_then_recover", at=0.1 * span,
                                 down_time=0.02 * span, up_time=0.08 * span),
        "flapping_stragglers": get("flapping_stragglers", span=span),
        "slow_ramp_mix": get("slow_ramp_mix", span=span),
        "thermal_throttle_fleet": get("thermal_throttle_fleet", span=span),
        "poisson_storm": get("poisson_storm", rate=4.0 / span, t_end=span,
                             mttr=0.25 * span),
        "degraded_rejoins": get("degraded_rejoins", span=span),
        "aging_fleet": get("aging_fleet", span=span),
        "lemon_devices": get("lemon_devices", span=span),
        "infant_mortality": get("infant_mortality", span=span),
    }


def compile_seed_timelines(topo: ClusterTopology, span: float,
                           seed: int = 0) -> dict:
    """name -> (t, kind, target, value) timeline for every catalog seed."""
    out = {}
    for name, scen in catalog_seeds(span).items():
        out[name] = tuple((float(ev.t), ev.kind, int(ev.target),
                           float(ev.value))
                          for ev in scen.compile(topo, seed))
    return out


# --------------------------------------------------------- damage / repair
def damage(timeline: Sequence[tuple], topo: ClusterTopology) -> float:
    """The adversary's spent failure budget: 1.0 per fail-stopped device,
    the lost speed fraction per fail-slow, and the comm-share-weighted loss
    per net-degraded node. Rejoins/restores give nothing back — the budget
    prices injected faults, not their net effect."""
    total = 0.0
    for t, kind, target, value in timeline:
        if kind == "fail-stop":
            total += 1.0
        elif kind == "fail-stop-node":
            total += topo.devices_per_node
        elif kind == "fail-slow":
            total += 1.0 - value
        elif kind == "net-degrade":
            total += 0.3 * topo.devices_per_node * (1.0 - value)
    return total


def damage_cap(topo: ClusterTopology, span: float, seed: int = 0) -> float:
    """The worst hand-authored storm's failure budget at this scale: mined
    candidates may not inject more total damage than the catalog's heaviest
    scenario, so a winner is a worse *pattern*, not just a bigger hammer."""
    return max(damage(tl, topo)
               for tl in compile_seed_timelines(topo, span, seed).values())


def repair_timeline(timeline: Sequence[tuple], topo: ClusterTopology,
                    span: float, *, max_events: int = 64,
                    cap: Optional[float] = None) -> tuple:
    """Canonicalize an arbitrary event soup into a valid timeline.

    Deterministic (no RNG): clamp times into ``[0, span]`` and targets into
    range (mod n — remapping is what lets a mined 256-device pattern replay
    on any topology), clamp values into their legal ranges, sort by the
    Event ordering, then walk the per-device state machine dropping every
    event :meth:`EventTrace.validate` would reject (double kills, rejoins
    of healthy devices, net-restores without a degrade) and every fail
    event past the damage ``cap``. The result always validates; a valid
    in-budget timeline passes through unchanged (bar float rounding to 6
    decimals, which the miner applies everywhere)."""
    n_dev, n_nodes = topo.n_devices, topo.n_nodes
    cleaned = []
    for t, kind, target, value in timeline:
        if kind in DEVICE_KINDS:
            target = int(target) % n_dev
        elif kind in NODE_KINDS:
            target = int(target) % n_nodes
        else:
            continue  # callbacks and unknown kinds are not minable
        t = round(min(max(float(t), 0.0), span), 6)
        value = float(value)
        if kind == "fail-slow":
            value = min(max(value, 0.05), 1.0)
        elif kind == "net-degrade":
            value = min(max(value, 0.05), 1.0)
        elif kind == "rejoin":
            value = value if 0.0 < value < 1.0 else 0.0
        else:
            value = 0.0
        cleaned.append((t, kind, target, round(value, 6)))
    # the Event sort key (t, kind, target, value) — the exact order
    # EventTrace will replay in, so the state walk below sees replay order
    cleaned.sort()
    alive: dict = {}
    degraded: set = set()
    net_down: set = set()
    spent = 0.0
    out = []
    for t, kind, target, value in cleaned:
        if kind == "fail-stop":
            if not alive.get(target, True):
                continue
            if cap is not None and spent + 1.0 > cap + 1e-9:
                continue
            spent += 1.0
            alive[target] = False
        elif kind == "fail-stop-node":
            devs = range(target * topo.devices_per_node,
                         (target + 1) * topo.devices_per_node)
            if all(not alive.get(d, True) for d in devs):
                continue
            cost = float(topo.devices_per_node)
            if cap is not None and spent + cost > cap + 1e-9:
                continue
            spent += cost
            for d in devs:
                alive[d] = False
        elif kind == "fail-slow":
            if not alive.get(target, True):
                continue
            cost = 1.0 - value
            if cap is not None and spent + cost > cap + 1e-9:
                continue
            spent += cost
            degraded.add(target)
        elif kind == "rejoin":
            if alive.get(target, True) and target not in degraded:
                continue
            alive[target] = True
            degraded.discard(target)
            if 0.0 < value < 1.0:
                degraded.add(target)
        elif kind == "net-degrade":
            cost = 0.3 * topo.devices_per_node * (1.0 - value)
            if cap is not None and spent + cost > cap + 1e-9:
                continue
            spent += cost
            net_down.add(target)
        elif kind == "net-restore":
            if target not in net_down:
                continue
            net_down.discard(target)
        out.append((t, kind, target, value))
        if len(out) >= max_events:
            break  # validity is prefix-closed: a truncated tail stays valid
    return tuple(out)


# ------------------------------------------------------ mutation operators
def _pick(rng: np.random.Generator, evs: list) -> int:
    return int(rng.integers(0, len(evs)))


def _rand_event(rng, topo, span) -> tuple:
    kind = FAIL_KINDS[int(rng.integers(0, len(FAIL_KINDS)))]
    t = float(rng.uniform(0.0, span))
    if kind in NODE_KINDS:
        target = int(rng.integers(0, topo.n_nodes))
    else:
        target = int(rng.integers(0, topo.n_devices))
    value = float(rng.uniform(0.05, 0.95)) if kind in ("fail-slow",
                                                       "net-degrade") else 0.0
    return (t, kind, target, value)


def _op_jitter_time(evs, rng, topo, span, pool):
    """Perturb the times of a few events (shift a failure into or out of a
    detection/replanning window)."""
    for _ in range(int(rng.integers(1, 4))):
        i = _pick(rng, evs)
        t, kind, target, value = evs[i]
        evs[i] = (t + float(rng.normal(0.0, 0.08 * span)), kind, target, value)
    return evs


def _op_scale_time(evs, rng, topo, span, pool):
    """Compress or stretch the whole storm (burstiness is an axis the
    hand-authored catalog barely explores)."""
    f = float(np.exp(rng.normal(0.0, 0.35)))
    return [(t * f, kind, target, value) for t, kind, target, value in evs]


def _op_perturb_value(evs, rng, topo, span, pool):
    """Resample a severity / link scale / rejoin return speed."""
    i = _pick(rng, evs)
    t, kind, target, value = evs[i]
    if kind in ("fail-slow", "net-degrade"):
        value = float(rng.uniform(0.05, 0.95))
    elif kind == "rejoin":
        # half the draws return the device degraded, half at full health
        value = float(rng.uniform(0.2, 0.95)) if rng.uniform() < 0.5 else 0.0
    evs[i] = (t, kind, target, value)
    return evs


def _op_retarget(evs, rng, topo, span, pool):
    """Move a few events to new victims."""
    for _ in range(int(rng.integers(1, 4))):
        i = _pick(rng, evs)
        t, kind, target, value = evs[i]
        hi = topo.n_nodes if kind in NODE_KINDS else topo.n_devices
        evs[i] = (t, kind, int(rng.integers(0, hi)), value)
    return evs


def _op_shift_targets(evs, rng, topo, span, pool):
    """Shift every victim id by one offset: the same pattern landing on a
    different set of TP groups / racks (structure-preserving retarget)."""
    off = int(rng.integers(1, topo.n_devices))
    out = []
    for t, kind, target, value in evs:
        mod = topo.n_nodes if kind in NODE_KINDS else topo.n_devices
        out.append((t, kind, (target + off) % mod, value))
    return out


def _op_drop(evs, rng, topo, span, pool):
    """Remove events (minimization pressure: simpler timelines that keep
    the score survive clustering better)."""
    for _ in range(int(rng.integers(1, 4))):
        if len(evs) > 1:
            evs.pop(_pick(rng, evs))
    return evs


def _op_duplicate(evs, rng, topo, span, pool):
    """Repeat an existing event at a jittered time/target (recurrence —
    the repeat-offender pattern)."""
    t, kind, target, value = evs[_pick(rng, evs)]
    t = t + float(rng.normal(0.0, 0.15 * span))
    hi = topo.n_nodes if kind in NODE_KINDS else topo.n_devices
    if rng.uniform() < 0.5:
        target = int(rng.integers(0, hi))
    evs.append((t, kind, target, value))
    return evs


def _op_insert(evs, rng, topo, span, pool):
    """Inject fresh primitive events."""
    for _ in range(int(rng.integers(1, 3))):
        evs.append(_rand_event(rng, topo, span))
    return evs


def _op_splice(evs, rng, topo, span, pool):
    """Splice a time window of another timeline into this one (the
    subsequence-recombination operator: compound failures no single
    generator emits)."""
    donor = pool[int(rng.integers(0, len(pool)))]
    if donor:
        lo = float(rng.uniform(0.0, span))
        hi = lo + float(rng.uniform(0.1, 0.5)) * span
        evs.extend(e for e in donor if lo <= e[0] < hi)
    return evs


def _op_compose(evs, rng, topo, span, pool):
    """Overlay a whole donor timeline (family composition)."""
    evs.extend(pool[int(rng.integers(0, len(pool)))])
    return evs


OPERATORS = (
    _op_jitter_time, _op_scale_time, _op_perturb_value, _op_retarget,
    _op_shift_targets, _op_drop, _op_duplicate, _op_insert, _op_splice,
    _op_compose,
)


def mutate(timeline: Sequence[tuple], rng: np.random.Generator,
           topo: ClusterTopology, span: float, pool: Sequence[tuple], *,
           max_events: int = 64, cap: Optional[float] = None) -> tuple:
    """Apply 1-3 random operators, then repair to a valid in-budget
    timeline. Deterministic given the rng state."""
    evs = list(timeline)
    for _ in range(int(rng.integers(1, 4))):
        op = OPERATORS[int(rng.integers(0, len(OPERATORS)))]
        evs = op(evs, rng, topo, span, pool)
        if not evs:
            evs = [_rand_event(rng, topo, span)]
    return repair_timeline(evs, topo, span, max_events=max_events, cap=cap)


# ------------------------------------------------------- cluster signature
def _bucket(n: float) -> int:
    """Coarse log2 bucket: 0, 1, 2, 2, 3, 3, 3, 3, 4, ..."""
    return int(n).bit_length() if n > 0 else 0


def signature(timeline: Sequence[tuple], topo: ClusterTopology,
              span: float) -> tuple:
    """Coarse feature signature of a timeline — the clustering key.

    Two candidates with the same signature are considered the same failure
    *pattern* (the archive keeps only the worse one); distinct signatures
    are distinct patterns, ranked separately in the mined output. Features:
    log-bucketed event-kind counts, victim spread (devices / nodes),
    a 3-bin temporal histogram of fail events, the mean fail-slow depth,
    and the peak number of concurrently-dead devices."""
    kinds = {k: 0 for k in ("fail-stop", "fail-stop-node", "fail-slow",
                            "net-degrade", "net-restore", "rejoin")}
    devices, nodes = set(), set()
    thirds = [0, 0, 0]
    sev_sum, sev_n = 0.0, 0
    alive: dict = {}
    max_down = down = 0
    for t, kind, target, value in timeline:
        kinds[kind] += 1
        if kind in NODE_KINDS:
            nodes.add(target)
        else:
            devices.add(target)
            nodes.add(topo.node_of(target))
        if kind in FAIL_KINDS:
            thirds[min(int(3.0 * t / max(span, 1e-9)), 2)] += 1
        if kind == "fail-slow":
            sev_sum += value
            sev_n += 1
        if kind == "fail-stop" and alive.get(target, True):
            alive[target] = False
            down += 1
            max_down = max(max_down, down)
        elif kind == "fail-stop-node":
            for d in range(target * topo.devices_per_node,
                           (target + 1) * topo.devices_per_node):
                if alive.get(d, True):
                    alive[d] = False
                    down += 1
            max_down = max(max_down, down)
        elif kind == "rejoin" and not alive.get(target, True):
            alive[target] = True
            down -= 1
    sev_bin = int(4.0 * sev_sum / sev_n) if sev_n else 0  # mean depth, 0-4
    return (
        _bucket(kinds["fail-stop"] + 8 * kinds["fail-stop-node"]),
        _bucket(kinds["fail-slow"]),
        _bucket(kinds["rejoin"]),
        _bucket(kinds["net-degrade"] + kinds["net-restore"]),
        _bucket(len(devices)),
        _bucket(len(nodes)),
        _bucket(thirds[0]), _bucket(thirds[1]), _bucket(thirds[2]),
        sev_bin,
        _bucket(max_down),
    )


# ------------------------------------------------------------- evaluation
def evaluate_candidate(job: tuple) -> dict:
    """Score one candidate timeline: run it under every policy and record
    session throughputs. Pure function of the job tuple (per-candidate
    seeding, deterministic engines) — safe to fan out across processes in
    any order. Shaped for ``benchmarks.sweep.pmap``."""
    timeline, cfg_kw, iters, policy_labels, engine = job
    from repro_torch.cluster.scenarios import TimelineScenario

    cfg = SimConfig(**cfg_kw)
    sessions, aborted, elapsed = {}, {}, {}
    for label in policy_labels:
        name, policy_kw = POLICIES[label]
        sim = TrainingSim(name, cfg, engine=engine, policy_kwargs=policy_kw)
        scen = TimelineScenario(span=1.0, timeline=timeline, permute=False,
                                label="mined")
        sim.apply_scenario(scen)
        sim.run(iters, stop_on_abort=False)
        sessions[label] = sim.session_throughput(skip=2)
        aborted[label] = sim.aborted
        elapsed[label] = float(sim.now)
    return {"session": sessions, "aborted": aborted, "elapsed": elapsed}


def score(result: dict, healthy: dict) -> dict:
    """Rank a candidate: ``resihp`` session-throughput loss vs healthy,
    plus half credit for the margin of any policy-ranking flip (a baseline
    ``resihp`` normally beats finishing ahead of it)."""
    h = max(healthy["session"]["resihp"], 1e-9)
    resi = result["session"]["resihp"]
    loss = 1.0 - resi / h
    rivals = [v for k, v in result["session"].items() if k != "resihp"]
    flip_margin = max(0.0, (max(rivals) - resi) / h) if rivals else 0.0
    return {
        "score": round(loss + 0.5 * flip_margin, 9),
        "resihp_loss": round(loss, 9),
        "flip": bool(rivals) and max(rivals) > resi,
        "flip_margin": round(flip_margin, 9),
    }


# ------------------------------------------------------------- the search
def _serial_map(fn: Callable, items: list) -> list:
    return [fn(x) for x in items]


def mine(*, seed: int = 0, budget: int = 96, iters: int = 30,
         span: Optional[float] = None, cfg: Optional[SimConfig] = None,
         policies: Sequence[str] = ("resihp", "recycle+", "oobleck+"),
         engine: str = "fast", batch: int = 8, elites: int = 8,
         top_k: int = 8, max_events: int = 64,
         pool_map: Optional[Callable] = None) -> dict:
    """Run the coverage-guided search and return the mined report dict.

    ``budget`` counts evaluated candidates (catalog seeds included;
    the healthy baseline run is free). ``pool_map(fn, items)`` fans the
    per-candidate evaluation out (pass ``benchmarks.sweep.pmap`` bound to a
    worker count); the default is the in-process serial reference. The
    report is byte-identical (via :func:`to_json`) for a fixed
    ``(seed, budget, config)`` regardless of ``pool_map``."""
    cfg = cfg or mining_config()
    topo = mining_topology(cfg)
    policies = list(policies)
    pmap_fn = pool_map or _serial_map
    cfg_kw = dict(dp=cfg.dp, pp=cfg.pp, tp=cfg.tp, n_layers=cfg.n_layers,
                  n_microbatches=cfg.n_microbatches, seq_len=cfg.seq_len,
                  noise=cfg.noise, seed=cfg.seed,
                  devices_per_node=cfg.devices_per_node)

    def jobs(timelines):
        return [(tl, cfg_kw, iters, tuple(policies), engine)
                for tl in timelines]

    healthy = evaluate_candidate(((), cfg_kw, iters, tuple(policies), engine))
    if span is None:
        # front-load the storm window into the healthy session: events land
        # in the first 60% of a failure-free run, leaving recovery room that
        # session_throughput can observe (failures only stretch the session,
        # so every event inside this window actually fires)
        span = round(0.6 * healthy["elapsed"]["resihp"], 6)

    seed_tls = compile_seed_timelines(topo, span, seed)
    cap = max(damage(tl, topo) for tl in seed_tls.values())
    names = sorted(seed_tls)
    repaired = {n: repair_timeline(seed_tls[n], topo, span,
                                   max_events=max_events, cap=cap)
                for n in names}

    archive: dict = {}  # signature -> entry (best scorer per cluster)
    evaluated = 0

    def admit(label, timeline, result):
        sig = signature(timeline, topo, span)
        sc = score(result, healthy)
        entry = {
            "label": label,
            "signature": list(sig),
            "timeline": [list(e) for e in timeline],
            "n_events": len(timeline),
            "damage": round(damage(timeline, topo), 6),
            "session_throughput": {k: round(v, 9)
                                   for k, v in result["session"].items()},
            "aborted": result["aborted"],
            **sc,
        }
        best = archive.get(sig)
        if best is None or entry["score"] > best["score"]:
            archive[sig] = entry
        return entry

    # generation 0: the catalog itself (its scores double as the
    # worst-hand-authored baseline the acceptance criteria compare against)
    n_seeds = min(len(names), budget)
    seed_results = pmap_fn(evaluate_candidate,
                           jobs([repaired[n] for n in names[:n_seeds]]))
    catalog = {}
    for name, result in zip(names[:n_seeds], seed_results):
        entry = admit(f"seed:{name}", repaired[name], result)
        catalog[name] = {k: entry[k] for k in
                         ("score", "resihp_loss", "flip",
                          "session_throughput", "n_events", "damage")}
    evaluated += n_seeds

    gen = 0
    while evaluated < budget:
        gen += 1
        n = min(batch, budget - evaluated)
        # objective-diverse elite set: half the slots by combined score,
        # half by raw resihp loss — otherwise one objective's lineages
        # (e.g. wide-flip flap storms) crowd the pool and starve the search
        # for deepest-throughput-loss patterns
        by_score = sorted(archive.values(),
                          key=lambda e: (-e["score"], tuple(e["signature"])))
        by_loss = sorted(archive.values(),
                         key=lambda e: (-e["resihp_loss"],
                                        tuple(e["signature"])))
        elite, seen = [], set()
        for e in [x for pair in zip(by_score, by_loss) for x in pair]:
            sig = tuple(e["signature"])
            if sig not in seen:
                seen.add(sig)
                elite.append(e)
            if len(elite) >= elites:
                break
        donor_pool = [repaired[nm] for nm in names] + \
                     [tuple(tuple(e) for e in el["timeline"]) for el in elite]
        children, labels = [], []
        for i in range(n):
            parent = elite[i % len(elite)]
            rng = np.random.default_rng([seed & 0xFFFFFFFF, gen, i])
            child = mutate(tuple(tuple(e) for e in parent["timeline"]),
                           rng, topo, span, donor_pool,
                           max_events=max_events, cap=cap)
            children.append(child)
            labels.append(f"g{gen}.{i}<-{parent['label']}")
        for label, child, result in zip(
                labels, children, pmap_fn(evaluate_candidate, jobs(children))):
            admit(label, child, result)
        evaluated += n

    # the emitted survivors are *mined* patterns: un-mutated catalog seeds
    # stay in the archive (they steer the elite set and donor pool) and in
    # the ``catalog`` table below, but never rank as adversarial output
    ranked = [e for e in sorted(archive.values(),
                                key=lambda e: (-e["score"],
                                               tuple(e["signature"])))
              if not e["label"].startswith("seed:")]
    worst_name = min(catalog, key=lambda n: (-catalog[n]["score"], n))

    # the checked-in adversarial_* family: three signature-distinct mined
    # patterns covering the search objectives — best combined score, deepest
    # raw resihp session loss, widest policy-ranking flip (each backfilled
    # from the score ranking if it collides with an earlier pick)
    family = []
    fam_sigs = set()

    def pick(key):
        for e in sorted(ranked, key=key):
            if tuple(e["signature"]) not in fam_sigs:
                fam_sigs.add(tuple(e["signature"]))
                family.append(e)
                return

    pick(lambda e: (-e["score"], tuple(e["signature"])))
    pick(lambda e: (-e["resihp_loss"], tuple(e["signature"])))
    pick(lambda e: (-e["flip_margin"], tuple(e["signature"])))
    while len(family) < 3 and len(family) < len(ranked):
        pick(lambda e: (-e["score"], tuple(e["signature"])))

    return {
        "config": {
            "seed": seed, "budget": budget, "iters": iters, "span": span,
            "engine": engine, "policies": policies, "batch": batch,
            "elites": elites, "max_events": max_events,
            "damage_cap": round(cap, 6), "n_devices": cfg.n_devices,
            "model": cfg_kw,
        },
        "healthy": {k: round(v, 9) for k, v in healthy["session"].items()},
        "catalog": catalog,
        "worst_catalog": {"name": worst_name, **catalog[worst_name]},
        "n_archive": len(archive),
        "n_clusters": len(ranked),
        "clusters": [dict(rank=i + 1, **e)
                     for i, e in enumerate(ranked[:top_k])],
        "family": [dict(rank=i + 1, objective=obj, **e)
                   for i, (obj, e) in enumerate(
                       zip(("score", "resihp_loss", "flip_margin"), family))],
    }


def to_json(report: dict) -> str:
    """Canonical serialization: byte-identical for identical reports."""
    return json.dumps(report, indent=1, sort_keys=True)
