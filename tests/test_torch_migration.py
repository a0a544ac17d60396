"""The port's copy of Algorithm 1 (§6.3), `repro_torch.core.scheduler.migration`,
held to `repro.core.scheduler.migration`: the reference's cases
(tests/test_scheduler.py's migration invariants) and a hypothesis sweep over
stages, replicas, micro-batches, a dead or slow executor, the policy and
`delta`. Both are the same float arithmetic in Python, so `status`,
`makespan`, `finish`, `idle`, the per-replica finish and every
`MigrationEvent` (time, chunk, src, dst, reason) are equal exactly. Also
the placement the engine executes (`engine_placement`) and the Scheduler's
`migrator_kwargs` as the migrator's input."""
import pytest
from _ht import given, settings, strategies as st

from repro.core.scheduler import migration as ref
from repro.core.scheduler.plan import initial_plan as j_initial_plan
from repro.core.scheduler.scheduler import AdaptationPlan as JAdaptation, Scheduler as JScheduler
from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler import migration
from repro_torch.core.scheduler.plan import initial_plan
from repro_torch.core.scheduler.scheduler import AdaptationPlan, Scheduler


def _cost(cid, e):
    return {"F": 1.0, "B": 2.0, "W": 0.5}[cid.kind]


def _key(c):
    return (c.kind, c.mb, c.stage, c.replica)


def _same(kw):
    """Both migrators on `kw` -> the port's result, after asserting every
    field equal to the reference's."""
    ours, theirs = migration.ProgressAwareMigrator(**kw), ref.ProgressAwareMigrator(**kw)
    a, b = ours.run(), theirs.run()
    assert (a.status, a.makespan, a.detail) == (b.status, b.makespan, b.detail)
    assert {_key(c): t for c, t in a.finish.items()} == {_key(c): t for c, t in b.finish.items()}
    assert a.idle == b.idle and a.per_replica_finish == b.per_replica_finish
    assert ([(e.time, _key(e.chunk), e.src, e.dst, e.reason) for e in a.migrations]
            == [(e.time, _key(e.chunk), e.src, e.dst, e.reason) for e in b.migrations])
    assert ({_key(c): e for c, e in ours.placement.items()}
            == {_key(c): e for c, e in theirs.placement.items()})
    return a


def test_constants_match_reference():
    assert migration.SAME_TIME_EPS == ref.SAME_TIME_EPS
    assert (str(migration._budget_error(1.5, 3, 2, 10, 50))
            == str(ref._budget_error(1.5, 3, 2, 10, 50)))


@settings(max_examples=25, deadline=None)
@given(n_stages=st.integers(2, 4), n_replicas=st.integers(2, 3), n_mb=st.integers(2, 6),
       dead=st.booleans(), slow_stage=st.integers(0, 3))
def test_migration_completeness_matches_reference(n_stages, n_replicas, n_mb, dead, slow_stage):
    """The reference's completeness case: every chunk once, none on a dead
    executor, and the same run as the reference's."""
    slow_stage = slow_stage % n_stages
    cost = lambda cid, e: _cost(cid, e) * (2.0 if e == (0, slow_stage) else 1.0)  # noqa: E731
    dead_ex = [(1 % n_replicas, (slow_stage + 1) % n_stages)] if dead else []
    kw = dict(n_stages=n_stages, n_replicas=n_replicas, n_microbatches=n_mb, chunk_cost=cost,
              dead_executors=dead_ex, policy="resihp", delta=1)
    res = _same(kw)
    m = migration.ProgressAwareMigrator(**kw)
    m.run()
    assert res.status == "ok" and len(m.done) == len(m.chunks)
    assert all(m._executor_of(c) not in m.dead for c in m.done)


@pytest.mark.parametrize("case", ["memory", "healthy", "failslow", "failslow-none", "dead-none",
                                  "dead-resihp", "recycle"])
def test_reference_cases_match(case):
    """tests/test_scheduler.py's migration invariants, and the recycle
    policy's eviction, each run by both."""
    slow = lambda cid, e: _cost(cid, e) * (3.0 if e == (0, 1) else 1.0)  # noqa: E731
    kw = {
        "memory": dict(n_stages=3, n_replicas=2, n_microbatches=8, chunk_cost=_cost,
                       dead_executors=[(0, 1)], policy="resihp", mem_capacity=3),
        "healthy": dict(n_stages=4, n_replicas=2, n_microbatches=8, chunk_cost=_cost,
                        policy="resihp", delta=1),
        "failslow": dict(n_stages=4, n_replicas=2, n_microbatches=8, chunk_cost=slow,
                         policy="resihp", delta=1),
        "failslow-none": dict(n_stages=4, n_replicas=2, n_microbatches=8, chunk_cost=slow,
                              policy="none"),
        "dead-none": dict(n_stages=4, n_replicas=2, n_microbatches=6, chunk_cost=_cost,
                          dead_executors=[(0, 2)], policy="none"),
        "dead-resihp": dict(n_stages=4, n_replicas=2, n_microbatches=6, chunk_cost=_cost,
                            dead_executors=[(0, 2)], policy="resihp"),
        "recycle": dict(n_stages=4, n_replicas=3, n_microbatches=6, chunk_cost=_cost,
                        dead_executors=[(0, 2)], policy="recycle"),
    }[case]
    res = _same(kw)
    assert res.status == ("aborted" if case == "dead-none" else "ok")
    if case == "healthy":
        assert not res.migrations
    if case in ("failslow", "dead-resihp", "recycle", "memory"):
        assert res.migrations


def test_failslow_migration_beats_none():
    slow = lambda cid, e: _cost(cid, e) * (3.0 if e == (0, 1) else 1.0)  # noqa: E731
    kw = dict(n_stages=4, n_replicas=2, n_microbatches=8, chunk_cost=slow)
    assert (_same({**kw, "policy": "resihp", "delta": 1}).makespan
            < _same({**kw, "policy": "none"}).makespan)


def test_event_budget_error_matches():
    kw = dict(n_stages=4, n_replicas=2, n_microbatches=8, chunk_cost=_cost, event_budget=5)
    with pytest.raises(RuntimeError) as ours:
        migration.ProgressAwareMigrator(**kw).run()
    with pytest.raises(RuntimeError) as theirs:
        ref.ProgressAwareMigrator(**kw).run()
    assert str(ours.value) == str(theirs.value)


@settings(max_examples=40, deadline=None)
@given(n_stages=st.integers(2, 4), n_replicas=st.integers(2, 3), n_mb=st.integers(1, 6),
       fault=st.sampled_from(["none", "dead", "slow"]), executor=st.integers(0, 11),
       speed=st.sampled_from([0.2, 0.3, 0.5, 0.8]), delta=st.integers(0, 2),
       schedule=st.sampled_from(["1f1b", "gpipe", "zb-h1"]),
       policy=st.sampled_from(["resihp", "recycle", "none"]),
       per_replica=st.booleans(), p2p_cost=st.sampled_from([0.0, 0.05]))
def test_sweep_matches_reference(n_stages, n_replicas, n_mb, fault, executor, speed, delta,
                                 schedule, policy, per_replica, p2p_cost):
    """Stages, replicas, micro-batches (one count, or one per replica), a
    dead or slow executor, the schedule, the policy, `delta`, the P2P edge
    costs: the same run, exactly."""
    e = (executor % n_replicas, executor // n_replicas % n_stages)
    speeds = {e: speed} if fault == "slow" else {}

    def cost(cid, ex):
        return _cost(cid, ex) * (1.0 + 0.1 * cid.stage) / speeds.get(ex, 1.0)
    kw = dict(n_stages=n_stages, n_replicas=n_replicas,
              n_microbatches=[n_mb + r for r in range(n_replicas)] if per_replica else n_mb,
              chunk_cost=cost, schedule=schedule, policy=policy, delta=delta,
              dead_executors=[e] if fault == "dead" else [], p2p_cost=p2p_cost,
              migrate_edge_cost=2 * p2p_cost)
    _same(kw)
    res = migration.simulate_iteration(**kw)
    assert res.status in ("ok", "aborted")


def test_engine_placement_moves_each_chunk_with_its_backward():
    ev = [migration.MigrationEvent(4.0, ChunkId("F", 1, 1, 0), (0, 1), (1, 1), "fail-slow"),
          migration.MigrationEvent(6.0, ChunkId("F", 2, 0, 1), (1, 0), (0, 0), "fail-stop")]
    assert migration.engine_placement(ev) == {
        ChunkId("F", 1, 1, 0): (1, 1), ChunkId("B", 1, 1, 0): (1, 1),
        ChunkId("F", 2, 0, 1): (0, 0), ChunkId("B", 2, 0, 1): (0, 0)}
    assert migration.engine_placement([]) == {}


@pytest.mark.parametrize("schedule", ["1f1b", "zb-h1"])
def test_engine_placement_is_the_migrators_own(schedule):
    """At a fail-stop every migrated chunk's F and B move together: the
    engine's placement is the migrator's own placement without W chunks."""
    m = migration.ProgressAwareMigrator(n_stages=4, n_replicas=2, n_microbatches=6,
                                        chunk_cost=_cost, dead_executors=[(0, 2)],
                                        schedule=schedule, policy="resihp")
    res = m.run()
    assert res.migrations
    assert migration.engine_placement(res.migrations) == {
        c: e for c, e in m.placement.items() if c.kind != "W"}


@pytest.mark.parametrize("depth,slow,speed,delta,moved", [
    (4, (0, 1), 0.3, 0, [("F", 1, 1, 0, (0, 1), (1, 1))]),  # the CPU tests' stage meshes
    (8, (0, 1), 0.3, 0, [("F", 1, 1, 0, (0, 1), (1, 1))]),  # the card's final plan
    (8, (0, 1), 0.3, 1, []),  # `run_pipeline`'s delta: nothing moves at 2 micro-batches
    (8, (1, 0), 0.0, 0, None),  # a dead executor, by speed: its chunks go to replica 0
])
def test_scheduler_migrator_kwargs_match_reference(depth, slow, speed, delta, moved):
    """`Scheduler.migrator_kwargs` of a dp2/pp2 plan (the smoke script's
    final plan at 8 layers) with one executor's speed set: both migrators
    move the same chunks."""
    from repro.configs import get_arch as j_get_arch
    from repro.core.scheduler.repartition import costs_for_arch as j_costs
    from repro_torch.configs import get_arch
    from repro_torch.core.scheduler.repartition import costs_for_arch

    def run(plan_fn, sch_cls, adapt_cls, costs, mig):
        plan = plan_fn(depth, dp=2, pp=2, tp=2, microbatches=2)
        sch = sch_cls(layer_costs=costs, k_min=1, delta=1)
        speeds = {(r, s): 1.0 for r in range(2) for s in range(2)}
        speeds[slow] = speed
        dead = (slow,) if speed == 0.0 else ()
        kw = sch.migrator_kwargs(adapt_cls(plan=plan, stage_speeds=speeds, dead_stages=dead,
                                           restore_required=False, plan_overhead_s=0.0),
                                 n_mb=2, chunk_base_cost=lambda c: _cost(c, None))
        return {**kw, "delta": delta}, mig

    ours, _ = run(initial_plan, Scheduler, AdaptationPlan,
                  costs_for_arch(get_arch("qwen3-8b"), 4096), migration)
    theirs, _ = run(j_initial_plan, JScheduler, JAdaptation,
                    j_costs(j_get_arch("qwen3-8b"), 4096), ref)
    assert {k: v for k, v in ours.items() if k != "chunk_cost"} == {
        k: v for k, v in theirs.items() if k != "chunk_cost"}
    res = _same({**ours, "chunk_cost": theirs["chunk_cost"]})
    assert _same(ours).migrations == res.migrations
    got = [(*_key(e.chunk), e.src, e.dst) for e in res.migrations]
    if moved is not None:
        assert got == [tuple(m) for m in moved]
    else:
        mine = [e for e in res.migrations if e.src == slow]  # the dead stage's chunks, evicted
        assert mine and all(e.dst == (0, 0) and e.reason == "fail-stop" for e in mine)
