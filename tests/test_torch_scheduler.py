"""The port's copies of the JAX package's jax-free runtime modules, held to
their originals on the same inputs: pipeline schedules, plans, the
repartition and TP-reconfiguration steps, `Scheduler.adapt` over fail-stop
and fail-slow cases (the 8-layer full-width qwen3-8b ones of the smoke
script's pipeline phase among them), the DAG simulator, a ResiHPController
sequence, and a cold import of every module the runtime slice adds."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_arch as j_get_arch, reduced as j_reduced
from repro.core.detector.dag_sim import simulate_pipeline as j_simulate
from repro.core.detector.detector import Detector as JDetector, FailureReport as JReport
from repro.core.detector.heartbeat import HeartbeatMonitor as JHeartbeat
from repro.core.resihp import ResiHPController as JController
from repro.core.scheduler.plan import initial_plan as j_initial_plan
from repro.core.scheduler.repartition import (costs_for_arch as j_costs,
                                              partition_bottleneck as j_bottleneck,
                                              repartition_layers as j_repartition)
from repro.core.scheduler.scheduler import PlanOverheadModel as JOverhead, Scheduler as JScheduler
from repro.core.scheduler.tp_reconfig import reconfigure_tp_group as j_reconfigure
from repro.engine.schedules import make_schedule as j_make_schedule
from repro_torch.configs import get_arch, reduced
from repro_torch.core.detector.dag_sim import simulate_pipeline
from repro_torch.core.detector.detector import Detector, FailureReport
from repro_torch.core.detector.heartbeat import HeartbeatMonitor
from repro_torch.core.resihp import ResiHPController
from repro_torch.core.scheduler.plan import initial_plan
from repro_torch.core.scheduler.repartition import (costs_for_arch, partition_bottleneck,
                                                    repartition_layers)
from repro_torch.core.scheduler.scheduler import PlanOverheadModel, Scheduler
from repro_torch.core.scheduler.tp_reconfig import reconfigure_tp_group
from repro_torch.engine.schedules import make_schedule

ROOT = Path(__file__).resolve().parents[1]


def _chunks(sched):
    return {k: [(c.kind, c.mb, c.stage, c.replica) for c in v] for k, v in sched.items()}


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "1F1B", "zb", "zbh1", "zb-h1"])
@pytest.mark.parametrize("n_stages,n_mb,replica", [(2, 2, 0), (4, 8, 1), (3, 2, 0)])
def test_make_schedule_copy_matches(name, n_stages, n_mb, replica):
    assert (_chunks(make_schedule(name, n_stages, n_mb, replica=replica))
            == _chunks(j_make_schedule(name, n_stages, n_mb, replica=replica)))


@pytest.mark.parametrize("args", [(4, 2, 2, 1), (4, 2, 2, 2), (8, 2, 4, 2), (36, 1, 4, 4),
                                  (12, 3, 3, 2)])
def test_initial_plan_copy_matches(args):
    ours, ref = initial_plan(*args, microbatches=4), j_initial_plan(*args, microbatches=4)
    assert ours.summary() == ref.summary() and ours.devices == ref.devices
    assert ours.microbatches == ref.microbatches and ours.schedule == ref.schedule


def _cfgs(name):
    """(port cfg, JAX cfg): 'full6' and 'full8' are qwen3-8b at every
    published width cut to 6 layers (the smoke script's pipeline phase) and
    8 (its train phase)."""
    if name.startswith("full"):
        depth = int(name[4:])
        return (dataclasses.replace(get_arch("qwen3-8b"), n_layers=depth),
                dataclasses.replace(j_get_arch("qwen3-8b"), n_layers=depth))
    return reduced(get_arch("qwen3-8b"), n_layers=4), j_reduced(j_get_arch("qwen3-8b"), n_layers=4)


@pytest.mark.parametrize("name,seq", [("full8", 4096), ("reduced4", 64)])
def test_costs_and_repartition_copy_matches(name, seq):
    cfg, jcfg = _cfgs(name)
    costs = costs_for_arch(cfg, seq)
    assert costs == j_costs(jcfg, seq)
    for speeds in ([1.0, 0.5], [0.3, 1.0, 0.7], [1.0, 1.0, 1.0, 0.25]):
        parts = repartition_layers(costs, speeds)
        assert parts == j_repartition(costs, speeds)
        assert partition_bottleneck(costs, parts, speeds) == j_bottleneck(costs, parts, speeds)


@pytest.mark.parametrize("group,speeds,failed", [
    ((0, 1), {0: 1.0, 1: 1.0}, set()),
    ((0, 1), {0: 1.0, 1: 0.0}, {1}),
    ((0, 1, 2, 3), {0: 1.0, 1: 0.3, 2: 1.0, 3: 1.0}, set()),
    ((0, 1, 2, 3), {0: 0.9, 1: 0.5, 2: 0.0, 3: 1.0}, {2}),
    ((4, 5, 6, 7, 8, 9, 10, 11), {5: 0.2, 9: 0.6}, set()),
])
def test_tp_reconfig_copy_matches(group, speeds, failed):
    ours = reconfigure_tp_group(list(group), speeds, k_min=1, failed=failed)
    ref = j_reconfigure(list(group), speeds, k_min=1, failed=failed)
    assert (ours.tp, ours.devices, ours.standby, ours.effective_throughput, ours.mode) == (
        ref.tp, ref.devices, ref.standby, ref.effective_throughput, ref.mode)


# (plan args, seq, [(failed devices, {device: speed}), ...]): adapted in turn
ADAPT_CASES = {
    "full8_failstop_then_failslow": ("full8", (8, 2, 2, 2), 4096,
                                     [({5}, {5: 0.0}), ({5}, {1: 0.3})]),
    "full6_failstop_then_failslow": ("full6", (6, 2, 2, 2), 4096,
                                     [({5}, {5: 0.0}), ({5}, {1: 0.3})]),
    "full8_failslow": ("full8", (8, 2, 2, 2), 4096, [(set(), {2: 0.5})]),
    "reduced_failstop_tp2": ("reduced4", (4, 2, 2, 2), 64, [({5}, {5: 0.0})]),
    "reduced_dead_stage_tp1": ("reduced4", (4, 2, 2, 1), 64, [({2}, {2: 0.0})]),
    "reduced_both_replicas_of_stage0": ("reduced4", (4, 2, 2, 1), 64,
                                        [({0, 2}, {0: 0.0, 2: 0.0})]),
    "full8_pp4_storm": ("full8", (8, 2, 4, 2), 4096,
                        [({3}, {3: 0.0}), ({3}, {9: 0.4}), ({3, 12}, {12: 0.0})]),
}


@pytest.mark.parametrize("case", sorted(ADAPT_CASES))
@pytest.mark.parametrize("ntp", [None, True])
def test_scheduler_adapt_copy_matches(case, ntp):
    """Plans, notes, dead stages, stage speeds and restore flags equal the
    reference's at every adaptation of the sequence (plan_overhead_s is a
    wall time and differs)."""
    name, args, seq, seq_of_faults = ADAPT_CASES[case]
    cfg, jcfg = _cfgs(name)
    ours = Scheduler(layer_costs=costs_for_arch(cfg, seq), k_min=1, delta=1, ntp=ntp)
    ref = JScheduler(layer_costs=j_costs(jcfg, seq), k_min=1, delta=1, ntp=ntp)
    plan, jplan = initial_plan(*args, microbatches=2), j_initial_plan(*args, microbatches=2)
    speeds = {d: 1.0 for d in plan.devices}
    for failed, change in seq_of_faults:
        speeds.update(change)
        a = ours.adapt(plan, dict(speeds), failed=failed)
        b = ref.adapt(jplan, dict(speeds), failed=failed)
        assert a.plan.summary() == b.plan.summary() and a.notes == b.notes
        assert a.dead_stages == b.dead_stages and a.restore_required == b.restore_required
        assert a.stage_speeds == b.stage_speeds and a.plan.standby == b.plan.standby
        plan, jplan = a.plan, b.plan


def test_scheduler_sequence_of_the_smoke_phase():
    """The smoke script's pipeline injections at full width, 6 layers: the
    fail-stop of device 5 takes (dp1,pp0) to TP 1 and moves the split 3/3 ->
    2/4; the fail-slow of device 1 then takes (dp0,pp0) to TP 1 without a
    repartition. At 8 layers the same faults move 4/4 -> 2/6."""
    for depth, first, second in (
            (6, "dp0[s0:tp2xL2 s1:tp2xL4] dp1[s0:tp1xL2 s1:tp2xL4]",
             "dp0[s0:tp1xL2 s1:tp2xL4] dp1[s0:tp1xL2 s1:tp2xL4] standby=[1]"),
            (8, "dp0[s0:tp2xL2 s1:tp2xL6] dp1[s0:tp1xL2 s1:tp2xL6]",
             "dp0[s0:tp1xL2 s1:tp2xL6] dp1[s0:tp1xL2 s1:tp2xL6] standby=[1]")):
        cfg, _ = _cfgs(f"full{depth}")
        sch = Scheduler(layer_costs=costs_for_arch(cfg, 4096), k_min=1, delta=1)
        plan = initial_plan(depth, 2, 2, 2, microbatches=2)
        speeds = {d: 1.0 for d in plan.devices}
        speeds[5] = 0.0
        a = sch.adapt(plan, speeds, failed={5})
        assert a.plan.summary() == first
        speeds[1] = 0.3
        b = sch.adapt(a.plan, speeds, failed={5})
        assert b.plan.summary() == second
        assert not b.restore_required and not b.dead_stages


def test_plan_overhead_model_copy_matches():
    samples = [(8, 8, 1e-4), (64, 36, 3e-3), (256, 80, 0.05)]
    ours, ref = PlanOverheadModel.fit(samples), JOverhead.fit(samples)
    assert (ours.coef, ours.intercept, ours.fit_mape) == (ref.coef, ref.intercept, ref.fit_mape)
    assert PlanOverheadModel().predict(256, 80) == JOverhead().predict(256, 80)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe", "zb-h1"])
def test_dag_simulator_copy_matches(schedule):
    def cost(cid, executor):
        return {"F": 1.0, "B": 2.0, "W": 1.0}[cid.kind] * (1.0 + 0.1 * cid.stage)

    ours = simulate_pipeline(4, 6, cost, schedule=schedule, p2p_cost=0.05)
    ref = j_simulate(4, 6, cost, schedule=schedule, p2p_cost=0.05)
    (total, finish, idle), (j_total, j_finish, j_idle) = ours, ref
    assert total == j_total and idle == j_idle
    assert {repr(k): v for k, v in finish.items()} == {repr(k): v for k, v in j_finish.items()}


def test_resihp_controller_sequence_matches():
    """The same fail-stop, fail-slow and rejoin reports, adapted in turn: the
    same plans, stage speeds and events."""
    def make(ctl_cls, det_cls, hb_cls, sch_cls, costs):
        plan = (initial_plan if ctl_cls is ResiHPController else j_initial_plan)(
            8, 2, 2, 2, microbatches=2)
        hb = hb_cls()
        hb.register_node(0, list(plan.devices))
        det = det_cls(healthy_time_fn=lambda w: float("inf"), validate_fn=lambda it: [],
                      heartbeat=hb)
        return ctl_cls(scheduler=sch_cls(layer_costs=costs, k_min=1, delta=1), detector=det,
                       plan=plan, speeds={d: 1.0 for d in plan.devices})

    cfg, jcfg = _cfgs("full8")
    ours = make(ResiHPController, Detector, HeartbeatMonitor, Scheduler, costs_for_arch(cfg))
    ref = make(JController, JDetector, JHeartbeat, JScheduler, j_costs(jcfg))
    assert ours.adapt(0.0) is None and ref.adapt(0.0) is None
    steps = [("fail-stop", (5,), 0.0), ("fail-slow", ((1, 0.3),), 0.3), ("rejoin", (5,), 1.0)]
    for it, (kind, devices, value) in enumerate(steps):
        for ctl, report in ((ours, FailureReport), (ref, JReport)):
            if kind == "rejoin":
                ctl.inject_rejoin(devices, now=float(it))
                continue
            for d in devices:
                dev = d[0] if isinstance(d, tuple) else d
                ctl.speeds[dev] = value
            ctl.pending.append(report(kind, devices, it, float(it)))
        a, b = ours.adapt(float(it)), ref.adapt(float(it))
        assert a.plan.summary() == b.plan.summary() and a.notes == b.notes
        assert ours.stage_speeds == ref.stage_speeds and ours.speeds == ref.speeds
    assert len(ours.events) == len(ref.events) == 3
    assert [e.reports[0].kind for e in ours.events] == [e.reports[0].kind for e in ref.events]


RUNTIME_MODULES = [
    "repro_torch.core.detector.dag_sim", "repro_torch.engine.schedules",
    "repro_torch.core.scheduler.plan", "repro_torch.core.scheduler.repartition",
    "repro_torch.core.scheduler.tp_reconfig", "repro_torch.core.scheduler.scheduler",
    "repro_torch.core.resihp", "repro_torch.checkpoint.checkpoint", "repro_torch.checkpoint",
    "repro_torch.core.recovery", "repro_torch.launch.mesh", "repro_torch.engine.pipeline",
    "repro_torch.launch.train", "repro_torch.bridge", "repro_torch.core.scheduler.p2p",
    "repro_torch.core.scheduler.migration", "repro_torch.cluster", "repro_torch.cluster.baselines",
    "repro_torch.cluster.events", "repro_torch.cluster.fastsim", "repro_torch.cluster.hazard",
    "repro_torch.cluster.mining", "repro_torch.cluster.registry", "repro_torch.cluster.scenarios",
    "repro_torch.cluster.simulator", "repro_torch.cluster.workload",
    "repro_torch.core.detector.lifecycle", "repro_torch.core.detector.credit",
    "repro_torch.checkpoint.economics", "repro_torch.core.detector", "repro_torch.data",
]


@pytest.mark.parametrize("module", RUNTIME_MODULES)
def test_runtime_module_imports_cold(module):
    """Each module of the runtime slice imports first in a fresh interpreter
    (the reference's `repro.engine.schedules` does not: a circular import)
    and loads neither jax nor the JAX package."""
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
