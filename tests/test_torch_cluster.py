"""The port's cluster simulator (`repro_torch.cluster`) against the JAX
package's (`repro.cluster`): both goldens read by the port, side-by-side runs
of the two packages on the same `SimConfig` (both engines, the default-off
`lifecycle`, `hazard`, `domains` and `credit` switches of `ResiHPPolicy`),
every catalog scenario compiled on the golden's topology, and the building
blocks (event traces, hazard draws, workloads, the miner's repair and
mutation, topology domains), all equal exactly."""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.cluster import mining as j_mining, scenarios as j_scenarios
from repro.cluster.events import Event as JEvent, EventTrace as JEventTrace
from repro.cluster.hazard import (HazardConfig as JHazardConfig, HazardModel as JHazardModel,
                                  hazard_event_times as j_hazard_event_times)
from repro.cluster.registry import ClusterTopology as JTopology
from repro.cluster.simulator import SimConfig as JSimConfig, TrainingSim as JTrainingSim
from repro.cluster.workload import WorkloadGen as JWorkloadGen
from repro_torch.cluster import mining, scenarios
from repro_torch.cluster.events import Event, EventTrace
from repro_torch.cluster.hazard import HazardConfig, HazardModel, hazard_event_times
from repro_torch.cluster.registry import ClusterTopology
from repro_torch.cluster.simulator import SimConfig, TrainingSim
from repro_torch.cluster.workload import WorkloadGen

GOLDEN = Path(__file__).parent / "golden"

# the golden's run (tests/test_simulator_golden.py)
GOLDEN_KW = dict(dp=2, pp=2, tp=2, n_layers=8, n_microbatches=4, seq_len=2048, noise=0.01,
                 seed=0)
PINNED = {"plan_overhead_fixed": 0.25}


# ------------------------------------------------------------------ goldens
def _golden_observed(engine):
    sim = TrainingSim("resihp", SimConfig(**GOLDEN_KW), engine=engine, policy_kwargs=PINNED)
    compiled = sim.apply_scenario(scenarios.get("fig10_mixed", span=3.0))
    sim.run(60, stop_on_abort=False)
    return json.loads(json.dumps({
        "compiled_events": compiled.as_tuples(),
        "fired_events": [ev.as_tuple() for ev in sim.event_log],
        "cluster_log": [[t, kind, int(target), float(value)]
                        for t, kind, target, value in sim.cluster.events],
        "n_iters": len(sim.trace),
        "aborted": sim.aborted,
        "avg_throughput": sim.avg_throughput(skip=2),
        "session_throughput": sim.session_throughput(skip=2),
        "t_starts": [r.t_start for r in sim.trace],
        "durations": [r.duration for r in sim.trace],
        "iter_events": [[e[0] for e in r.events] for r in sim.trace],
    }))


@pytest.fixture(scope="module")
def sim_golden():
    return json.loads((GOLDEN / "simulator_golden.json").read_text())


@pytest.mark.parametrize("engine", ["fast", "python"])
def test_port_reproduces_simulator_golden(engine, sim_golden):
    """The reference's golden, with its fields and its bounds, from the port's
    simulator under either engine."""
    got = _golden_observed(engine)
    for key in ("compiled_events", "fired_events", "cluster_log", "n_iters", "aborted",
                "iter_events"):
        assert got[key] == sim_golden[key], key
    for key in ("avg_throughput", "session_throughput", "t_starts", "durations"):
        assert got[key] == pytest.approx(sim_golden[key], rel=1e-9), key


@pytest.fixture(scope="module")
def adv_golden():
    return json.loads((GOLDEN / "adversarial_golden.json").read_text())


@pytest.mark.parametrize("label", sorted(mining.POLICIES))
@pytest.mark.parametrize("name", ["adversarial_1", "adversarial_2", "adversarial_3"])
def test_port_reproduces_adversarial_golden(name, label, adv_golden):
    """Each mined scenario's per-policy session at the mining scale (256
    devices, 30 iterations, fast engine), as `tests/test_adversarial_golden.py`
    pins it."""
    policy, policy_kw = mining.POLICIES[label]
    sim = TrainingSim(policy, mining.mining_config(), engine="fast", policy_kwargs=policy_kw)
    sim.apply_scenario(scenarios.get(name))
    sim.run(30, stop_on_abort=False)
    pinned = adv_golden[name][label]
    assert sim.aborted == pinned["aborted"]
    assert len(sim.event_log) == pinned["n_fired"]
    assert sim.session_throughput(skip=2) == pytest.approx(pinned["session_throughput"],
                                                           rel=1e-9)
    assert sim.avg_throughput(skip=2) == pytest.approx(pinned["avg_throughput"], rel=1e-9)


# ------------------------------------------------------------- side by side
SMALL = dict(dp=2, pp=2, tp=2, n_layers=8, n_microbatches=4, seq_len=2048, noise=0.01, seed=0)
MID = dict(dp=2, pp=4, tp=4, n_layers=40, n_microbatches=8, seq_len=8192, noise=0.01, seed=0)

# (config, policy, policy kwargs, scenario, scenario overrides, engine, iterations)
SIDE_BY_SIDE = {
    "fast-resihp-slow_ramp": (SMALL, "resihp", {}, "slow_ramp_mix",
                              dict(span=1.0, devices=(2, 3, 5)), "fast", 40),
    "python-resihp-slow_ramp": (SMALL, "resihp", {}, "slow_ramp_mix",
                                dict(span=1.0, devices=(2, 3, 5)), "python", 40),
    "fast-lifecycle-flapping": (MID, "resihp", {"lifecycle": True}, "flapping_stragglers",
                                dict(span=100.0), "fast", 60),
    "python-lifecycle-flapping": (MID, "resihp", {"lifecycle": True}, "flapping_stragglers",
                                  dict(span=100.0), "python", 60),
    "fast-hazard-aging": (MID, "resihp", {"hazard": True}, "aging_fleet", dict(span=60.0),
                          "fast", 60),
    "fast-domains-pdu": (SMALL, "resihp", {"domains": True}, "pdu_brownout",
                         dict(span=2.0, max_events=8), "fast", 40),
    "python-domains-restart": (SMALL, "resihp", {"domains": True}, "restart_storm",
                               dict(span=5.0), "python", 40),
    "fast-credit-throttle": (SMALL, "resihp", {"credit": True, "ntp": True},
                             "thermal_throttle_fleet", dict(span=3.0, frac=0.5), "fast", 40),
    "python-credit-flapping": (MID, "resihp", {"credit": True}, "flapping_stragglers",
                               dict(span=100.0), "python", 60),
    "fast-recycle+-rack": (SMALL, "recycle+", {}, "rack_storm", dict(at=0.2, recover_after=0.5),
                           "fast", 40),
    "fast-oobleck+-poisson": (SMALL, "oobleck+", {}, "poisson_storm",
                              dict(rate=3.0, t_end=1.2, mttr=0.3), "fast", 40),
    "python-greyhound-fig9": (SMALL, "greyhound", {}, "fig9_failslow", dict(at=0.2), "python",
                              30),
    "fast-adaptra-fig10": (SMALL, "adaptra", {}, "fig10_mixed", dict(span=3.0), "fast", 30),
}


def _trace(sim_cls, cfg_cls, scen_mod, case):
    cfg, policy, kw, scenario, overrides, engine, iters = case
    pkw = dict(kw) if policy != "resihp" else {**PINNED, **kw}
    sim = sim_cls(policy, cfg_cls(**cfg), engine=engine, policy_kwargs=pkw)
    sim.apply_scenario(scen_mod.get(scenario, **overrides))
    sim.run(iters, stop_on_abort=False)
    return {
        "durations": [r.duration for r in sim.trace],
        "t_starts": [r.t_start for r in sim.trace],
        "throughputs": [r.throughput for r in sim.trace],
        "events": [[e[0] for e in r.events] for r in sim.trace],
        "fired": [ev.as_tuple() for ev in sim.event_log],
        "false_alarms": sim.detector.stats.false_alarms,
        "detector": sim.detector.stats.as_dict(),
        "lifecycle": sim.lifecycle.stats.as_dict() if sim.lifecycle is not None else None,
        "aborted": sim.aborted,
    }


@pytest.mark.parametrize("case", sorted(SIDE_BY_SIDE))
def test_simulator_matches_reference_side_by_side(case):
    ours = _trace(TrainingSim, SimConfig, scenarios, SIDE_BY_SIDE[case])
    ref = _trace(JTrainingSim, JSimConfig, j_scenarios, SIDE_BY_SIDE[case])
    assert ours["fired"]  # the scenario's events land inside the run
    assert ours == ref


# ---------------------------------------------------------- the catalog
@pytest.mark.parametrize("name", j_scenarios.names())
def test_catalog_scenario_compiles_as_reference(name):
    """Every catalog scenario on the golden's topology (8 devices), two
    seeds: the same event tuples as the reference's."""
    assert name in scenarios.names()
    topo, j_topo = ClusterTopology(1, 8), JTopology(1, 8)
    for seed in (0, 7):
        ours = scenarios.get(name).compile(topo, seed)
        ref = j_scenarios.get(name).compile(j_topo, seed)
        assert ours.as_tuples() == ref.as_tuples()
        assert ours.to_json() == ref.to_json()


def test_catalog_names_equal():
    assert scenarios.names() == j_scenarios.names()


# ----------------------------------------------------------- building blocks
def test_event_trace_json_round_trips_between_packages():
    tr = scenarios.get("fig10_mixed").compile(ClusterTopology(8, 8), 3)
    j_tr = j_scenarios.get("fig10_mixed").compile(JTopology(8, 8), 3)
    assert tr.to_json() == j_tr.to_json()
    back = EventTrace.from_json(j_tr.to_json())
    assert back == tr and back.to_json() == tr.to_json()
    assert JEventTrace.from_json(tr.to_json()).to_json() == tr.to_json()
    rows = [(1.0, "fail-stop", 3, 0.0), (2.0, "fail-slow", 5, 0.4), (3.0, "rejoin", 3, 0.0)]
    assert (EventTrace(Event(*r) for r in rows).to_json()
            == JEventTrace(JEvent(*r) for r in rows).to_json())


@pytest.mark.parametrize("kw", [
    dict(mttf_s=100.0, shape=3.0, age_spread_s=50.0, lemon_frac=0.2, lemon_factor=8.0),
    dict(mttf_s=400.0, shape=0.7, age_spread_s=0.0, lemon_frac=0.0, wear_per_repair=1.5),
    dict(mttf_s=200.0, shape=1.5, bad_domain_frac=0.3, bad_domain_factor=4.0, domain="pdu"),
])
def test_hazard_draws_equal(kw):
    def draws(cfg_cls, model_cls, times, topo):
        cfg = cfg_cls(**kw)
        rng = np.random.default_rng(42)
        m = model_cls(cfg, 32, rng, topo=topo)
        single = [m.sample_next(d, 0.0, rng) for d in range(32)]
        rng = np.random.default_rng(7)
        m = model_cls(cfg, 32, rng, topo=topo)
        seq = times(m, rng, t_start=0.0, t_end=2000.0, mttr=30.0, renewal=True,
                    max_events=64)
        return single, seq, [m.rate(d, 10.0) for d in range(32)], repr(cfg)

    ours = draws(HazardConfig, HazardModel, hazard_event_times,
                 ClusterTopology(8, 4, nodes_per_pdu=2))
    ref = draws(JHazardConfig, JHazardModel, j_hazard_event_times,
                JTopology(8, 4, nodes_per_pdu=2))
    assert ours == ref
    assert len(ours[1]) > 0


def _work(workload):
    return [[(w.n_tokens, w.sum_l2) for w in rep] for rep in workload.per_replica]


def test_workload_batches_equal():
    for kw in (dict(seq_len=2048, n_replicas=2, n_microbatches=4, seed=0),
               dict(seq_len=8192, n_replicas=4, n_microbatches=6, rows_per_microbatch=2,
                    seed=3)):
        ours, ref = WorkloadGen(**kw), JWorkloadGen(**kw)
        for _ in range(4):
            a, b = next(ours), next(ref)
            assert _work(a) == _work(b) and a.totals() == b.totals()
        assert _work(ours.for_iteration(17)) == _work(ref.for_iteration(17))


MINE_TOPO = dict(n_nodes=4, devices_per_node=4)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_repair_and_mutate_equal_on_a_seed(seed):
    topo, j_topo = ClusterTopology(**MINE_TOPO), JTopology(**MINE_TOPO)
    pool = [tl for _, tl in sorted(mining.compile_seed_timelines(topo, 10.0, seed=0).items())]
    j_pool = [tl for _, tl in sorted(j_mining.compile_seed_timelines(j_topo, 10.0,
                                                                     seed=0).items())]
    assert pool == j_pool
    cap = max(mining.damage(tl, topo) for tl in pool)
    assert cap == max(j_mining.damage(tl, j_topo) for tl in j_pool)

    rng = np.random.default_rng([0x50FA, seed])
    kinds = ("fail-stop", "fail-stop-node", "fail-slow", "net-degrade", "net-restore", "rejoin")
    soup = [(float(rng.uniform(-2.0, 15.0)), kinds[int(rng.integers(0, len(kinds)))],
             int(rng.integers(-5, 48)), float(rng.uniform(-0.5, 1.5)))
            for _ in range(int(rng.integers(5, 40)))]
    assert (mining.repair_timeline(soup, topo, 10.0, max_events=48, cap=cap)
            == j_mining.repair_timeline(soup, j_topo, 10.0, max_events=48, cap=cap))

    def mutant(mod, t, p):
        r = np.random.default_rng([0xAD5E, seed])
        parent = p[int(r.integers(0, len(p)))]
        return mod.mutate(parent, r, t, 10.0, p, max_events=48, cap=cap)

    child = mutant(mining, topo, pool)
    assert child == mutant(j_mining, j_topo, j_pool)
    assert mining.signature(child, topo, 10.0) == j_mining.signature(child, j_topo, 10.0)


def test_topology_domains_equal():
    for args, kw in (((8, 8), dict(nodes_per_pdu=2, nodes_per_switch=4)),
                     ((3, 4), dict(nodes_per_pdu=2)), ((32, 8), {})):
        ours, ref = ClusterTopology(*args, **kw), JTopology(*args, **kw)
        assert (ours.n_devices, ours.n_pdus, ours.n_switches) == (ref.n_devices, ref.n_pdus,
                                                                   ref.n_switches)
        for kind in ("pdu", "switch", "rack", "node"):
            assert ([ours.domain_of(d, kind) for d in range(ours.n_devices)]
                    == [ref.domain_of(d, kind) for d in range(ref.n_devices)])
        assert ([ours.domain_devices("pdu", p) for p in range(ours.n_pdus)]
                == [ref.domain_devices("pdu", p) for p in range(ref.n_pdus)])
        assert ([ours.domain_nodes("switch", s) for s in range(ours.n_switches)]
                == [ref.domain_nodes("switch", s) for s in range(ref.n_switches)])
