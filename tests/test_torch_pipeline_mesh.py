"""The port's pipeline engine on per-stage meshes across ranks, on the CPU:
spawned gloo worlds of 8, 4 and 1 ranks (`torch_dist_helpers`), reduced
qwen3-8b at 4 layers (the reference's engine tests' config), weights from
the JAX init through `bridge.params_from_jax`, fp32, batches from
`SyntheticPackedDataset(seed=3)`:

  * meshes: each stage's ranks and coordinates for the dp2/pp2/tp2 plan (8
    plan devices) and the plan after the fail-stop of device 5, on worlds of
    8, 4 (stages r0s0 and r1s0 share ranks {0, 1}) and 1 (every stage
    degraded to rank 0); a plan applied again makes no new mesh;
  * the stage policy against the reference rule (`repro.engine.pipeline`
    `apply_plan`) and the JAX `spec_for` on every stage leaf;
  * fail-stop on 8 ranks (TP 2 on two ranks a stage, then TP 1 on rank 4
    for r1s0, rank 5 in no stage) and on 4 (shared ranks): AdamW lr 5e-3, 4
    steps, the fail-stop, 4 more; the losses against the JAX engine driven
    through the same plans (relative 1e-4) and the port's single-process
    engine (1e-5), the masters equal bit for bit on every rank; on 1 rank
    the losses equal the single-process engine's bit for bit;
  * a stage whose attention the reference rule splits on head_dim (6
    heads, tp 4) on 4 ranks against the single-process engine;
  * the migration identity on 8 ranks (the chunk crosses ranks);
  * Fig. 7's hand-offs (`engine.pipeline.boundary_routes`): on 8 ranks the
    fail-stop run again with every pair moved whole, losses and masters
    equal bit for bit, and the world's bytes per hand-off equal to
    `p2p_cost_bytes` (TP 2 -> 2, then 1 -> 2 and 2 -> 1); on 4 ranks a
    hand-off between two stages on the same ranks sends nothing;
  * the port migrator's placement (`ProgressAwareMigrator`, executor (0, 1)
    at speed 0.3, delta 0) executed on 8 ranks against the unplaced loss
    and the JAX engine given the JAX migrator's placement;
  * the pipeline driver on 8 ranks with `--inject-failstop 3:5`, and its
    restart determinism on 4.

The JAX losses are computed in the test process, while the ranks run; the
workers get numpy weights and batches and import no jax. The JAX engine
computes in bf16; for the 1e-4 comparison its `embed_tokens` is patched to
fp32 (the JAX package is not edited), as in tests/test_torch_pipeline.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.core.scheduler.migration import ProgressAwareMigrator as JMigrator
from repro.core.scheduler.p2p import p2p_cost_bytes as j_p2p_cost_bytes
from repro.core.scheduler.plan import initial_plan as j_initial_plan
from repro.core.scheduler.repartition import costs_for_arch as j_costs_for_arch
from repro.core.scheduler.scheduler import AdaptationPlan as JAdaptation, Scheduler as JScheduler
from repro.data.synth import SyntheticPackedDataset
from repro.engine import pipeline as j_pipeline
from repro.models.model import init_params as j_init_params
from repro.parallel import sharding as j_sharding
from repro.parallel.sharding import split_annotations
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.core.scheduler.p2p import p2p_cost_bytes
from repro_torch.core.scheduler.plan import initial_plan
from repro_torch.engine.pipeline import stage_part
from repro_torch.models.model import param_axes
from repro_torch.parallel.sharding import stage_policy

import torch_dist_helpers as dh

CFG = reduced(get_arch("qwen3-8b"), n_layers=dh.PIPE_LAYERS)
STEPS, FAULT_AT = 8, 4
AFTER = "dp0[s0:tp2xL1 s1:tp2xL3] dp1[s0:tp1xL1 s1:tp2xL3]"  # the reference's plan string
HEAD_DIM_OVER = {"n_heads": 6, "n_kv_heads": 2}
SLOW = ((0, 1), 0.3, 0)  # the migrator's case: executor (0, 1) at speed 0.3, delta 0
MOVED = [("B", 1, 1, 0, (1, 1)), ("F", 1, 1, 0, (1, 1))]  # what it moves: mb 1 of r0s1
# a boundary tensor: one micro-batch (8 rows over 2 replicas x 2) x PIPE_SEQ x d_model, fp32
TENSOR_BYTES = 2 * dh.PIPE_SEQ * CFG.d_model * 4


class FakeMesh:
    """The reference's test mesh: sizes only."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


def _jparams(cfg=CFG):
    params, _ = split_annotations(j_init_params(jax.random.PRNGKey(0), cfg))
    return params


def _batches(n, B=8):
    ds = SyntheticPackedDataset(CFG, dh.PIPE_SEQ, B, seed=3)
    return [ds.batch_at(i) for i in range(n)]


def _driver_argv(*extra):
    return ["--reduced", "--mode", "pipeline", "--seq-len", str(dh.PIPE_SEQ), "--device", "cpu",
            *extra]


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The three worlds, started at once when the module's first test runs,
    and the JAX engine's run and the port's single-process engine's (in this
    process, which has no process group) beside them; `get(world)` joins
    one -> {rank: {case: result}}; `get("jax")` -> `_jax_losses()`;
    `get("single")` -> {"single": the fail-stop run, "head_dim": the
    head_dim run}."""
    params = jax.tree.map(np.asarray, _jparams())
    failstop = {"kind": "failstop", "params": params, "batches": _batches(STEPS),
                "fault_at": FAULT_AT}
    # a stage whose heads tp 4 does not divide: attention split on head_dim
    hd_cfg = reduced(get_arch("qwen3-8b"), n_layers=dh.PIPE_LAYERS, **HEAD_DIM_OVER)
    head_dim = {"kind": "failstop", "over": HEAD_DIM_OVER, "plan": {"dp": 1, "pp": 1, "tp": 4},
                "params": jax.tree.map(np.asarray, _jparams(hd_cfg)),
                "batches": _batches(2, B=4), "fault_at": None}
    ckpt = tmp_path_factory.mktemp("pipeline-ckpt")

    def restart(steps, sub, resume):
        return _driver_argv("--steps", str(steps), "--batch", "4", "--ckpt-dir", str(ckpt / sub),
                            "--ckpt-interval", "3", *(["--resume"] if resume else []))
    placed = {"kind": "placement", "params": params, "batch": _batches(1)[0]}
    cases = {
        8: {"meshes": {"kind": "meshes"}, "failstop": failstop,
            "failstop_whole": {**failstop, "route": "whole"},
            "migration": {"kind": "migration", "params": params, "batch": _batches(1)[0]},
            "migrator": {**placed, "migrator": SLOW},
            "driver": {"kind": "driver", "runs": [_driver_argv(
                "--dp", "2", "--pp", "2", "--tp", "2", "--steps", "6", "--batch", "8",
                "--inject-failstop", "3:5")]}},
        4: {"meshes": {"kind": "meshes"}, "failstop": failstop, "head_dim": head_dim,
            # F of (mb 0, r0s1) on r1s1, its B at home: both stages on ranks {2, 3}
            "shared": {**placed, "placement": [("F", 0, 1, 0, (1, 1))]},
            "restart": {"kind": "driver", "runs": [restart(6, "a", False), restart(3, "b", False),
                                                    restart(6, "b", True)]}},
        1: {"meshes": {"kind": "meshes"}, "failstop": failstop},
    }
    groups = {world: dh.launch(dh.pipeline_cases, world, c) for world, c in cases.items()}
    # while the ranks run: the JAX engine, and the port's single-process one here
    jax_run, jax_migrator = _jax_losses(), _jax_migrator_losses()
    single = {"single": dh.single_process(failstop), "head_dim": dh.single_process(head_dim)}

    def get(world):
        if world in ("jax", "single", "jax_migrator"):
            return {"jax": jax_run, "single": single, "jax_migrator": jax_migrator}[world]
        return groups[world].results()
    yield get
    for g in groups.values():
        try:
            g.results(timeout=30)
        except RuntimeError:
            pass


def _jax_losses():
    """The JAX engine's 8 losses in fp32 through the same plans (its
    `embed_tokens` patched to fp32, as tests/test_torch_pipeline.py does)
    and its plan after the fail-stop."""
    j_embed = j_pipeline.embed_tokens
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipeline, "embed_tokens", lambda cfg, p, tokens: j_embed(cfg, p, tokens,
                                                                        jnp.float32))
    try:
        plan = j_initial_plan(dh.PIPE_LAYERS, dp=2, pp=2, tp=2, microbatches=2)
        eng = j_pipeline.PipelineEngine(CFG, plan, optimizer=j_make_optimizer("adamw", lr=5e-3),
                                        seed=0)
        losses = []
        for i, batch in enumerate(_batches(STEPS)):
            if i == FAULT_AT:
                speeds = {d: 1.0 for d in plan.devices}
                speeds[5] = 0.0
                ad = JScheduler(layer_costs=j_costs_for_arch(CFG, dh.PIPE_SEQ)).adapt(
                    plan, speeds, failed={5})
                eng.apply_plan(ad.plan)
            losses.append(eng.run_iteration({k: jnp.asarray(v) for k, v in batch.items()})[0])
    finally:
        mp.undo()
    return losses, ad.plan.summary()


def _jax_migrator_losses():
    """The JAX migrator's placement at `SLOW` on the initial dp2/pp2/tp2
    plan (its Scheduler's `migrator_kwargs`, chunk costs F 1, B 2, W 0.5)
    and the JAX engine's fp32 loss of the migration batch without and with
    it -> (placement as (kind, mb, stage, replica, dst), base, placed)."""
    plan = j_initial_plan(dh.PIPE_LAYERS, dp=2, pp=2, tp=2, microbatches=2)
    slow, speed, delta = SLOW
    speeds = {(r, s): 1.0 for r in range(2) for s in range(2)}
    speeds[slow] = speed
    kw = JScheduler(layer_costs=j_costs_for_arch(CFG, dh.PIPE_SEQ)).migrator_kwargs(
        JAdaptation(plan=plan, stage_speeds=speeds, dead_stages=(), restore_required=False,
                    plan_overhead_s=0.0),
        n_mb=2, chunk_base_cost=lambda cid: {"F": 1.0, "B": 2.0, "W": 0.5}[cid.kind])
    moved = JMigrator(**{**kw, "delta": delta}).run().migrations
    placement = {}
    for ev in moved:
        f = ev.chunk
        placement[f] = placement[type(f)("B", f.mb, f.stage, f.replica)] = ev.dst
    j_embed = j_pipeline.embed_tokens
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipeline, "embed_tokens", lambda cfg, p, tokens: j_embed(cfg, p, tokens,
                                                                        jnp.float32))
    try:
        eng = j_pipeline.PipelineEngine(CFG, plan, seed=0)
        batch = {k: jnp.asarray(v) for k, v in _batches(1)[0].items()}
        base = eng.run_iteration(batch)[0]
        placed = eng.run_iteration(batch, placement=placement)[0]
    finally:
        mp.undo()
    return sorted((c.kind, c.mb, c.stage, c.replica, tuple(d)) for c, d in placement.items()), \
        base, placed


def _world_bytes(logs):
    """Every rank's hand-off logs, [rank][iteration] = [(src, dst, tp_src,
    tp_dst, bytes it sent)] (every rank logs every hand-off, in one order)
    -> [iteration] = [(src, dst, tp_src, tp_dst, bytes the world sent)]."""
    out = []
    for it in range(len(logs[0])):
        rows = [log[it] for log in logs]
        assert all([x[:4] for x in row] == [x[:4] for x in rows[0]] for row in rows)
        out.append([(*x[:4], sum(row[k][4] for row in rows)) for k, x in enumerate(rows[0])])
    return out


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("world,before,after", [
    (8, {"dp0,pp0": [0, 1], "dp0,pp1": [2, 3], "dp1,pp0": [4, 5], "dp1,pp1": [6, 7]},
     {"dp0,pp0": [0, 1], "dp0,pp1": [2, 3], "dp1,pp0": [4], "dp1,pp1": [6, 7]}),
    (4, {"dp0,pp0": [0, 1], "dp0,pp1": [2, 3], "dp1,pp0": [0, 1], "dp1,pp1": [2, 3]},
     {"dp0,pp0": [0, 1], "dp0,pp1": [2, 3], "dp1,pp0": [0], "dp1,pp1": [2, 3]}),
    (1, {k: [0] for k in ("dp0,pp0", "dp0,pp1", "dp1,pp0", "dp1,pp1")},
     {k: [0] for k in ("dp0,pp0", "dp0,pp1", "dp1,pp0", "dp1,pp1")}),
])
def test_stage_meshes_over_rank_subsets(spawned, world, before, after):
    """Plan device d runs on rank d % world; a stage that maps two plan
    devices onto one rank degrades to its first (world 1); each member's
    coordinate is (0, its index), every other rank's None; on a world of 4
    r0s0 and r1s0 share one mesh; applying a plan again makes no new mesh."""
    results = spawned(world)
    for rank, res in results.items():
        got = res["meshes"]
        assert got["plan_after"] == AFTER
        for view, want in (("before", before), ("after", after)):
            assert {k: ranks for k, (ranks, _) in got[view].items()} == want, (rank, view)
            for k, (ranks, coord) in got[view].items():
                assert coord == ([0, ranks.index(rank)] if rank in ranks else None), (rank, k)
        assert got["shared"] == (world < 8)
        assert got["reused"], rank
    # distinct rank sets, one mesh each: 4 + 1 on 8 ranks, 2 + 1 on 4, 1 on 1
    assert results[0]["meshes"]["meshes_made"] == {8: [4, 5], 4: [2, 3], 1: [1, 1]}[world]


# ------------------------------------------------------------------ policy
def _reference_rule(cfg, tp):
    """The reference engine's attention rule (`repro.engine.pipeline`
    `PipelineEngine.apply_plan`, :95-103)."""
    if tp and cfg.n_heads % tp == 0:
        return "heads"
    if tp and cfg.head_dim % tp == 0:
        return "head_dim"
    return None


@pytest.mark.parametrize("tp,over,rule", [
    (1, {}, "heads"), (2, {}, "heads"), (4, {}, "heads"),
    (4, {"n_heads": 6, "n_kv_heads": 2}, "head_dim"),  # 6 heads over 4: their 16 dims split
    (3, {}, None),  # neither 4 heads nor 16 dims over 3
])
def test_stage_policy_matches_reference_rule(tp, over, rule):
    """`sharding.stage_policy` on a (1, tp) mesh: the reference's attn_shard,
    no batch split, and the spec of every stage leaf of dp1/pp2 equal to
    the JAX `spec_for` under the rule's attn_shard."""
    cfg = reduced(get_arch("qwen3-8b"), n_layers=dh.PIPE_LAYERS, **over)
    tcfg = t_reduced(t_get_arch("qwen3-8b"), n_layers=dh.PIPE_LAYERS, **over)
    assert _reference_rule(cfg, tp) == rule
    pol = stage_policy(FakeMesh(1, tp), tcfg)
    assert pol.attn_shard == rule and not pol.shard_batch and pol.tp == tp
    jpol = j_sharding.ShardingPolicy(mesh=FakeMesh(1, tp), dp_axes=("data",), tp_axis="model",
                                     shard_batch=False, attn_shard=rule)
    params, axes = split_annotations(j_init_params(jax.random.PRNGKey(0), cfg))
    plan = initial_plan(dh.PIPE_LAYERS, dp=1, pp=2, tp=tp, microbatches=2)
    checked = 0
    for s in range(2):
        t_axes = stage_part(tcfg, plan, param_axes(tcfg), 0, s)
        j_axes = stage_part(tcfg, plan, axes, 0, s)
        j_vals = stage_part(tcfg, plan, params, 0, s)
        flat_t = jax.tree.leaves(t_axes, is_leaf=lambda x: isinstance(x, tuple))
        flat_j = jax.tree.leaves(j_axes, is_leaf=lambda x: isinstance(x, tuple))
        flat_v = jax.tree.leaves(j_vals)
        assert flat_t == flat_j and len(flat_t) == len(flat_v)
        for ax, v in zip(flat_t, flat_v):
            want = tuple(jpol.spec_for(ax, v.shape))
            assert pol.spec_for(ax, v.shape) == want + (None,) * (v.ndim - len(want)), (s, ax)
            checked += 1
    assert checked == len(jax.tree.leaves(params))


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("world", [8, 4])
def test_failstop_on_stage_meshes_matches_jax_engine(spawned, world):
    """dp2/pp2/tp2, AdamW lr 5e-3, 4 steps, the fail-stop of device 5, 4
    more, every stage an SPMD program on its ranks: the 8 losses equal the
    JAX engine's (relative 1e-4) and the single-process engine's (1e-5),
    every rank returns the same losses and ends with the same master bit
    for bit. On 8 ranks each stage computes TP 2 on two ranks (wq's heads
    halved), then r1s0 runs at TP 1 on rank 4, and rank 5 runs nothing."""
    jl, jplan = spawned("jax")
    results = spawned(world)
    single = spawned("single")["single"]
    assert not single["spmd"] and single["plans"][1] == jplan == AFTER
    res = {rank: r["failstop"] for rank, r in results.items()}
    assert all(r["spmd"] for r in res.values())
    assert all(r["losses"] == res[0]["losses"] for r in res.values())
    assert len({r["digest"] for r in res.values()}) == 1
    assert res[0]["plans"] == single["plans"]
    np.testing.assert_allclose(res[0]["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(res[0]["losses"], single["losses"], rtol=1e-5)
    H, D = CFG.n_heads, CFG.d_model
    if world == 8:
        for rank, r in res.items():
            stage = {0: (0, 0), 1: (0, 0), 2: (0, 1), 3: (0, 1), 4: (1, 0), 5: (1, 0),
                     6: (1, 1), 7: (1, 1)}[rank]
            assert r["stages_before"] == [(*stage, 2, (D, H // 2, CFG.head_dim))], rank
        assert res[4]["stages_after"] == [(1, 0, 1, (D, H, CFG.head_dim))]
        assert res[5]["stages_after"] == []
    else:  # ranks 0 and 1 hold r0s0 and r1s0, 2 and 3 both second stages
        assert [x[:3] for x in res[0]["stages_before"]] == [(0, 0, 2), (1, 0, 2)]
        assert [x[:3] for x in res[0]["stages_after"]] == [(0, 0, 2), (1, 0, 1)]
        assert [x[:3] for x in res[1]["stages_after"]] == [(0, 0, 2)]


def test_head_dim_split_stage_on_four_ranks(spawned):
    """dp1/pp1/tp4 with 6 heads: the stage policy splits attention on
    head_dim (the reference rule) and the stage runs on 4 ranks; 2 AdamW
    steps equal the single-process engine's to 1e-5, on every rank."""
    res = {rank: r["head_dim"] for rank, r in spawned(4).items()}
    single = spawned("single")["head_dim"]
    assert all(r["spmd"] and r["attn_shard"] == "head_dim" for r in res.values())
    assert all(r["losses"] == res[0]["losses"] for r in res.values())
    assert len({r["digest"] for r in res.values()}) == 1
    np.testing.assert_allclose(res[0]["losses"], single["losses"], rtol=1e-5)


def test_one_rank_stage_meshes_equal_the_single_process_engine(spawned):
    """On a world of 1 every stage runs on the one-rank (1, 1) mesh (the
    card's case): the 8 losses and the master equal the single-process
    engine's bit for bit."""
    res, single = spawned(1)[0]["failstop"], spawned("single")["single"]
    assert res["spmd"] and not single["spmd"]
    assert res["losses"] == single["losses"]
    assert res["digest"] == single["digest"]


def test_migration_identity_across_ranks(spawned):
    """F and B of (mb 0, stage 1, replica 0) on replica 1's ranks (6, 7 in
    place of 2, 3; bf16, the reference's test): the same loss within 1e-5,
    on every rank."""
    res = {rank: r["migration"] for rank, r in spawned(8).items()}
    assert all(r == res[0] for r in res.values())
    assert abs(res[0]["base"] - res[0]["migrated"]) < 1e-5


# ------------------------------------------------------ Fig. 7 hand-offs
def test_hand_offs_scatter_and_gather_as_fig7(spawned):
    """The fail-stop run on 8 ranks by Fig. 7's rule and again with every
    pair moved whole: losses and every rank's master equal bit for bit.
    Each hand-off is between disjoint stage groups, and the world sends
    `p2p_cost_bytes` (one tensor) by the rule, where the whole route sends
    tp_dst tensors (the engine's route before the rule); the run covers TP
    2 -> 2 before the fail-stop, 1 -> 2 (r1s0's activations) and 2 -> 1
    (the gradients back) after it."""
    results = spawned(8)
    for rank, r in results.items():
        assert r["failstop"]["losses"] == r["failstop_whole"]["losses"], rank
        assert r["failstop"]["digest"] == r["failstop_whole"]["digest"], rank
    fig7, whole = (_world_bytes([r[case]["hand_offs"] for r in results.values()])
                   for case in ("failstop", "failstop_whole"))
    pairs = set()
    for it, (rows, wrows) in enumerate(zip(fig7, whole)):
        assert len(rows) == 8  # 2 replicas x 2 micro-batches, forward and back
        for (src, dst, tp_src, tp_dst, sent), w in zip(rows, wrows):
            assert sent == p2p_cost_bytes(TENSOR_BYTES, tp_src, tp_dst) == TENSOR_BYTES
            assert sent == j_p2p_cost_bytes(TENSOR_BYTES, tp_src, tp_dst)
            assert w[4] == tp_dst * TENSOR_BYTES == p2p_cost_bytes(
                TENSOR_BYTES, tp_src, tp_dst, scatter_gather=False)
            pairs.add((it >= FAULT_AT, tp_src, tp_dst))
    assert pairs == {(False, 2, 2), (True, 2, 2), (True, 1, 2), (True, 2, 1)}


def test_hand_off_between_stages_on_shared_ranks_sends_nothing(spawned):
    """On 4 ranks r0s1 and r1s1 both run on ranks {2, 3}: F of (mb 0,
    r0s1) placed on r1s1 and its B at home moves the activation from
    r1s1 to r0s1, which no byte crosses; every other hand-off is between
    disjoint groups and sends one tensor; the loss is the unplaced one."""
    res = {rank: r["shared"] for rank, r in spawned(4).items()}
    assert all(r["placed"] == res[0]["placed"] for r in res.values())
    assert abs(res[0]["placed"] - res[0]["base"]) <= 1e-5
    (base,), (placed,) = (_world_bytes([[r[key]] for r in res.values()])
                          for key in ("base_hand_offs", "hand_offs"))
    assert [x[4] for x in base] == [TENSOR_BYTES] * 8
    shared = [x for x in placed if x[:2] == ((1, 1), (0, 1))]
    assert len(shared) == 1 and shared[0][4] == 0
    assert all(x[4] == TENSOR_BYTES for x in placed if x[:2] != ((1, 1), (0, 1)))


def test_migrator_placement_runs_on_stage_meshes(spawned):
    """The port migrator's placement at executor (0, 1) 0.3, delta 0 on
    the initial plan, executed on 8 ranks in fp32: the reference
    migrator's placement (F and B of mb 1 of r0s1 onto r1s1); the moved
    chunk's activation and gradient cross between replica groups by the
    rule (one tensor each); the loss within 1e-5 of the unplaced one and
    within 1e-4 of the JAX engine's under the JAX migrator's placement."""
    res = {rank: r["migrator"] for rank, r in spawned(8).items()}
    j_placement, j_base, j_placed = spawned("jax_migrator")
    assert res[0]["placement"] == j_placement == MOVED
    assert all(r["placed"] == res[0]["placed"] for r in res.values())
    assert abs(res[0]["placed"] - res[0]["base"]) <= 1e-5
    np.testing.assert_allclose(res[0]["placed"], j_placed, rtol=1e-4)
    np.testing.assert_allclose(res[0]["base"], j_base, rtol=1e-4)
    (placed,) = _world_bytes([[r["hand_offs"]] for r in res.values()])
    crossing = [x for x in placed if {x[0][0], x[1][0]} == {0, 1}]
    assert [x[:2] for x in crossing] == [((0, 0), (1, 1)), ((1, 1), (0, 0))]
    assert all(x[4] == TENSOR_BYTES for x in placed)


# ------------------------------------------------------------------ driver
def test_driver_failstop_on_eight_ranks(spawned):
    """The port's counterpart of `test_fault_tolerant_training_subprocess_8dev`:
    `launch.train.main` in pipeline mode on 8 ranks, dp2/pp2/tp2, fail-stop
    of device 5 at step 3 -> one reconfiguration at step 3, the reference's
    plan string, finite losses, the same on every rank; each step the world
    sends 8 boundary tensors (bf16) between stage groups, each once."""
    res = {rank: r["driver"][0] for rank, r in spawned(8).items()}
    r = res[0]
    assert r["reconfigs"] == [3]
    assert all(x["hand_off_bytes"] == [8 * TENSOR_BYTES // 2] * 6 for x in res.values())
    assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 6
    (ad,) = r["adaptations"]
    assert ad["plan"] == r["plan"] == AFTER
    assert ad["restored_from"] is None and len(ad["moves"]) == 1 and ad["bytes"] > 0
    assert all(x["losses"] == r["losses"] for x in res.values())


def test_driver_restart_determinism_on_four_ranks(spawned):
    """Pipeline mode on 4 ranks (dp2/pp2/tp1, a stage a rank): 6 steps
    straight against 3 + save (rank 0) + restart (every rank restores) + 3,
    the same last loss within 1e-5."""
    straight, _, restarted = spawned(4)[0]["restart"]
    assert len(restarted["losses"]) == 3
    assert restarted["losses"][-1] == pytest.approx(straight["losses"][-1], abs=1e-5)
