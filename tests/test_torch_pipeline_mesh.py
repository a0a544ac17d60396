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
from repro.core.scheduler.plan import initial_plan as j_initial_plan
from repro.core.scheduler.repartition import costs_for_arch as j_costs_for_arch
from repro.core.scheduler.scheduler import Scheduler as JScheduler
from repro.data.synth import SyntheticPackedDataset
from repro.engine import pipeline as j_pipeline
from repro.models.model import init_params as j_init_params
from repro.parallel import sharding as j_sharding
from repro.parallel.sharding import split_annotations
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.core.scheduler.plan import initial_plan
from repro_torch.engine.pipeline import stage_part
from repro_torch.models.model import param_axes
from repro_torch.parallel.sharding import stage_policy

import torch_dist_helpers as dh

CFG = reduced(get_arch("qwen3-8b"), n_layers=dh.PIPE_LAYERS)
STEPS, FAULT_AT = 8, 4
AFTER = "dp0[s0:tp2xL1 s1:tp2xL3] dp1[s0:tp1xL1 s1:tp2xL3]"  # the reference's plan string
HEAD_DIM_OVER = {"n_heads": 6, "n_kv_heads": 2}


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
    cases = {
        8: {"meshes": {"kind": "meshes"}, "failstop": failstop,
            "migration": {"kind": "migration", "params": params, "batch": _batches(1)[0]},
            "driver": {"kind": "driver", "runs": [_driver_argv(
                "--dp", "2", "--pp", "2", "--tp", "2", "--steps", "6", "--batch", "8",
                "--inject-failstop", "3:5")]}},
        4: {"meshes": {"kind": "meshes"}, "failstop": failstop, "head_dim": head_dim,
            "restart": {"kind": "driver", "runs": [restart(6, "a", False), restart(3, "b", False),
                                                    restart(6, "b", True)]}},
        1: {"meshes": {"kind": "meshes"}, "failstop": failstop},
    }
    groups = {world: dh.launch(dh.pipeline_cases, world, c) for world, c in cases.items()}
    # while the ranks run: the JAX engine, and the port's single-process one here
    jax_run = _jax_losses()
    single = {"single": dh.single_process(failstop), "head_dim": dh.single_process(head_dim)}

    def get(world):
        if world in ("jax", "single"):
            return {"jax": jax_run, "single": single}[world]
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


# ------------------------------------------------------------------ driver
def test_driver_failstop_on_eight_ranks(spawned):
    """The port's counterpart of `test_fault_tolerant_training_subprocess_8dev`:
    `launch.train.main` in pipeline mode on 8 ranks, dp2/pp2/tp2, fail-stop
    of device 5 at step 3 -> one reconfiguration at step 3, the reference's
    plan string, finite losses, the same on every rank."""
    res = {rank: r["driver"][0] for rank, r in spawned(8).items()}
    r = res[0]
    assert r["reconfigs"] == [3]
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
